"""The spatial split's inner loop on the card: `chip_smoke.py`'s build,
`[kernels]` (every kernel, the split shapes of K1-K3 and K5's (mean, M2)
among them), `[spatial]` and `[extra]` phases alone, in about two minutes
against the whole script's four.

    python3 scripts/torch_spatial_smoke.py [--no-kernels] [--log PATH]

`[spatial]` spawns four processes on the one GPU (gloo over a FileStore,
host copies for the collectives) that run the SD-1.5 512 px edit on
cfg2xsp2 with `chip_smoke.build_models`' weights and the DDPM 256 px edit
on sp4, each held against the same run whole in this process, then the
same pieces and two guided steps under `fused_conv` (K7's halo form on
every rank) and under `conv_mode("int8_large", int8_bwd=True)`;
`[kernels]` holds K7's halo form at a rank's rows; `[extra]` holds item
19's blocks through K8. `--no-kernels` skips
`[kernels]`; `--log PATH` also writes everything printed to PATH. Exits
non-zero when a phase fails.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class _Tee:
    def __init__(self, *streams):
        self.streams = streams

    def write(self, text):
        for s in self.streams:
            s.write(text)

    def flush(self):
        for s in self.streams:
            s.flush()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--no-kernels", action="store_true", help="skip [kernels]")
    ap.add_argument("--log", default=None, help="also write the output to this file")
    args = ap.parse_args()
    if args.log:
        os.makedirs(os.path.dirname(os.path.abspath(args.log)), exist_ok=True)
        sys.stdout = _Tee(sys.__stdout__, open(args.log, "w"))

    import torch

    import chip_smoke as C

    t0 = time.perf_counter()
    smi = C.phase_device()
    C.phase_build()
    if not args.no_kernels:
        C.phase_kernels()
    unet, vae = C.build_models(torch.device("cuda"))
    C.log(f"[spatial] rank 0's launches {C.phase_spatial(smi, unet, vae)}")
    del unet, vae
    torch.cuda.empty_cache()
    C.log(f"[extra] launches {C.phase_extra(smi)}")
    C.log(f"done in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
