"""build_s: seconds the port spent compiling its kernels in this run (nvcc,
in `ops._build.build`, in set-up): the program's counter `ops.compile_ns`.
0 where an earlier run in the same checkout left every library built; the
first run in a fresh checkout reads the whole build. None from a program
without the counter registry."""


def read(ctx):
    try:
        from diffusion_image_editing_tpu_torch.utils.logging import COUNTERS
    except ImportError:
        return None
    return COUNTERS.get("ops.compile_ns", 0) / 1e9
