"""SDXL on the port, at TINY widths on the CPU: the SDXL UNet (per-level
transformer depth and heads, linear projections, `text_time` added
conditioning) against the plain float32 reference in
`benchmark/reference/sdxl.py` on the same seeded weights, the `SDXL`
wrapper through `EditPipeline` and `seed_sweep_generate` against the
reference's DDIM, the transformer-block counter, and SD-1.5's UNet as it
was.

Tolerances: the port and the reference compute the same float32
operations in other orders and groupings (the port's attention, group norm
and convolutions are its own plain versions on the CPU), so they part by
float32 rounding only, about 1e-6 relative; the limits are 1e-4 for one
UNet call and 1e-3 for whole loops of a few steps, which rounding over a
handful of chained calls stays far below, while a dropped or altered piece
of the conditioning moves eps by more than 1e-2 (second test)."""

import dataclasses
import hashlib

import pytest
import torch

from benchmark.harness.weights import fill_seeded
from benchmark.reference import diffusion as R
from benchmark.reference import sdxl as RX
from diffusion_image_editing_tpu_torch import models as M
from diffusion_image_editing_tpu_torch.core import schedule_for_model
from diffusion_image_editing_tpu_torch.pipeline import (SDXL, EditPipeline, SDXLText,
                                                         create_diffusion_model)
from diffusion_image_editing_tpu_torch.utils.logging import COUNTERS

CPU = torch.device("cpu")
SEED = 2 ** 31 + 25
UNET_TOL = 1e-4  # one call: float32 rounding of the same operations, ~1e-6
LOOP_TOL = 1e-3  # a few chained calls, inversion and nudges: still rounding alone
STEPS = 3
POOLED = (M.TINY_SDXL_UNET.projection_class_embeddings_input_dim
          - 6 * M.TINY_SDXL_UNET.addition_time_embed_dim)
# sha256 of SD-1.5's UNet state-dict keys and shapes before SDXL's keys were added
SD15_KEYS = "58c635be5bc35738835dd6ccfad1ec576b6398a12c6141744614af988dc11009"


def rel(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


def _pair():
    """The port's TINY SDXL UNet and the reference's, the same seeded weights."""
    unet = M.UNet2DCondition(M.TINY_SDXL_UNET, device=CPU)
    cfg = {f.name: getattr(M.TINY_SDXL_UNET, f.name)
           for f in dataclasses.fields(M.TINY_SDXL_UNET) if f.name != "fused_conv"}
    ref = RX.TorchSDXLUNet(RX.SDXLUNetConfig.from_dict(cfg))
    fill_seeded(unet, SEED, "unet", torch.float32, CPU)
    fill_seeded(ref, SEED, "unet", torch.float32, CPU)
    return unet.eval(), ref.eval()


def _text(seed: int = 1) -> SDXLText:
    g = torch.Generator().manual_seed(seed)
    return SDXLText(torch.randn(2, 7, M.TINY_SDXL_UNET.cross_attention_dim, generator=g),
                    torch.randn(2, POOLED, generator=g),
                    torch.tensor([[1024.0, 1024, 0, 0, 1024, 1024]] * 2))


def _inputs(b: int = 2):
    g = torch.Generator().manual_seed(7)
    x = torch.randn(b, 4, 8, 8, generator=g)
    t = torch.tensor([901, 41][:b] + [501] * max(0, b - 2))
    text = _text()
    return x, t, text.context[:1].expand(b, -1, -1), text.text_embeds[:1].expand(b, -1), \
        text.time_ids[:1].expand(b, -1)


def test_sdxl_unet_matches_the_reference():
    unet, ref = _pair()
    assert set(unet.state_dict()) == set(ref.state_dict())
    x, t, ctx, pooled, ids = _inputs()
    with torch.no_grad():
        got = unet(x, t, ctx, added_cond={"text_embeds": pooled, "time_ids": ids})
        want = ref(x, t, ctx, pooled, ids)
    assert rel(got, want) < UNET_TOL


@pytest.mark.parametrize("which", ["text_embeds", "time_ids"])
def test_added_conditioning_moves_eps(which):
    unet, _ = _pair()
    x, t, ctx, pooled, ids = _inputs()
    cond = {"text_embeds": pooled, "time_ids": ids}
    changed = dict(cond, **{which: pooled * -1.0 if which == "text_embeds"
                            else torch.tensor([[512.0, 768, 64, 0, 1024, 1024]] * 2)})
    with torch.no_grad():
        base, moved = unet(x, t, ctx, added_cond=cond), unet(x, t, ctx, added_cond=changed)
    assert rel(moved, base) > 1e-2


def _wrapper(steps: int = STEPS):
    unet, ref = _pair()
    vae = M.AutoencoderKL(dataclasses.replace(M.TINY_VAE, sample_size=16, scaling_factor=0.13025),
                          device=CPU)
    fill_seeded(vae, SEED, "vae", torch.float32, CPU)
    w = SDXL(unet, vae, schedule_for_model("sdxl", steps, clip_sample=False), _text(), device=CPU)
    return w, ref


def _ref_eps(ref, text: SDXLText, scale: float = 5.0):
    return RX.cfg_eps(ref, text.context, text.text_embeds, text.time_ids, scale)


def _schedule():
    return R.make_schedule(dict(num_train_timesteps=1000, beta_start=0.00085, beta_end=0.012,
                                beta_schedule="scaled_linear", steps_offset=1,
                                set_alpha_to_one=False), STEPS, CPU)


def test_sdxl_seed_sweep_matches_the_reference_ddim():
    from diffusion_image_editing_tpu_torch.parallel import seed_sweep_generate

    w, ref = _wrapper()
    seeds = [11, 12]
    got = seed_sweep_generate(w.schedule, w.eps_fn(w.prep_text(None)), (1, 4, 8, 8), seeds,
                              device=CPU).reshape(2, 4, 8, 8)
    s = _schedule()
    xt = torch.cat([torch.randn((1, 4, 8, 8), generator=torch.Generator().manual_seed(n))
                    for n in seeds])
    with torch.no_grad():
        want = R.guided_loop(s, _ref_eps(ref, w.text), xt, s.timesteps,
                             lambda i, x, e, t: R.ddim_step(s, x, e, t), None, None, [0.0],
                             range(0))
    assert rel(got, want) < LOOP_TOL


def test_sdxl_edit_pipeline_matches_the_reference():
    """A DDIM inversion and a colour-guided edit of two images through
    EditPipeline, at the pipeline's CFG scale, against the reference's."""
    from diffusion_image_editing_tpu_torch.guidance import SingleColorAttrFunc

    w, ref = _wrapper()
    pipe = EditPipeline(w)
    img = torch.rand((2, 3, 16, 16), generator=torch.Generator().manual_seed(3)) * 2 - 1
    attr = SingleColorAttrFunc(loss_scale=30.0, target=0.9, color_idx=0, t1=0, t2=STEPS,
                               vjp_chunk=2)
    xt = pipe.prepare_real_image_edit(img, inversion_method="ddim", cfg_scale=5.0)[0]
    out = pipe.edit_image(xt, attr_func=attr, cfg_scale=5.0)

    s, eps = _schedule(), _ref_eps(ref, w.text)
    vcfg = dataclasses.asdict(dataclasses.replace(M.TINY_VAE, sample_size=16,
                                                  scaling_factor=0.13025))
    from benchmark.reference import configs as RC
    from benchmark.reference import models as RM

    codec = RM.TorchAutoencoderKL(RC.AutoencoderConfig.from_dict(
        {k: v for k, v in vcfg.items() if k != "fused_conv"}))
    fill_seeded(codec, SEED, "vae", torch.float32, CPU)
    with torch.no_grad():
        want_xt = R.ddim_invert(s, eps, codec.encode_mode(img) * 0.13025)
    assert rel(xt, want_xt) < LOOP_TOL

    def decode(z):
        return codec.decode(z / 0.13025)

    def loss(d):
        return R.colour_loss(d, 0.9, 0)

    x0 = R.guided_loop(s, eps, want_xt, s.timesteps, lambda i, x, e, t: R.ddim_step(s, x, e, t),
                       decode, loss, [30.0, 30.0], range(STEPS))
    with torch.no_grad():
        want = decode(x0)
    assert rel(out.imgs, want) < LOOP_TOL


@pytest.mark.parametrize("config,blocks", [(M.TINY_SDXL_UNET, 8), (M.TINY_SD_UNET, 4)])
@pytest.mark.parametrize("batch", [1, 3])
def test_transformer_block_counter_counts_the_config_blocks(config, blocks, batch):
    unet = M.UNet2DCondition(config, device=CPU).eval()
    x = torch.randn(batch, 4, 8, 8)
    ctx = torch.randn(batch, 5, config.cross_attention_dim)
    added = None
    if config.addition_embed_type:
        added = {"text_embeds": torch.randn(batch, POOLED), "time_ids": torch.zeros(batch, 6)}
    before = COUNTERS["models.unet.transformer_blocks"]
    with torch.no_grad():
        unet(x, 10, ctx, added_cond=added)
    assert COUNTERS["models.unet.transformer_blocks"] - before == blocks
    assert config.num_transformer_blocks == blocks


def test_published_block_counts():
    assert M.SDXL_UNET.num_transformer_blocks == 70 and M.SDXL_UNET.num_transformers == 11
    assert M.SD15_UNET.num_transformer_blocks == M.SD15_UNET.num_transformers == 16


def test_sd15_unet_keeps_its_keys_and_config_fields():
    unet = M.UNet2DCondition(M.SD15_UNET, device="meta")
    h = hashlib.sha256()
    for k, v in unet.state_dict().items():
        h.update(f"{k}|{tuple(v.shape)};".encode())
    assert h.hexdigest() == SD15_KEYS
    assert [f.name for f in dataclasses.fields(M.UNet2DConditionConfig)] == [
        "sample_size", "in_channels", "out_channels", "block_out_channels", "down_block_types",
        "up_block_types", "layers_per_block", "attention_head_dim", "cross_attention_dim",
        "norm_num_groups", "norm_eps", "flip_sin_to_cos", "freq_shift", "fused_conv"]


def test_create_sdxl_at_published_sizes():
    w = create_diffusion_model("sdxl", device="meta")
    assert isinstance(w, SDXL) and w.family == "sdxl"
    assert sum(p.numel() for p in w.unet.parameters()) == 2_567_463_684
    assert w._codec()[1] == 0.13025 and w.data_dimensionality == 128
    assert tuple(w.text.context.shape) == (2, 77, 2048)
    assert tuple(w.text.text_embeds.shape) == (2, 1280)


def test_sdxl_refuses_what_it_cannot_carry():
    w, _ = _wrapper()
    with pytest.raises(ValueError, match="text encoders"):
        w.prep_text([1, 2, 3])
    with pytest.raises(ValueError, match="conditioning"):
        w.eps_fn(None)
    x, t, ctx, pooled, ids = _inputs()
    with pytest.raises(ValueError, match="added_cond"):
        w.unet(x, t, ctx)
    sd = M.UNet2DCondition(M.TINY_SD_UNET, device=CPU)
    with pytest.raises(ValueError, match="added_cond"):
        sd(x, t, torch.randn(2, 5, 32), added_cond={"text_embeds": pooled, "time_ids": ids})


def test_transformer_spans_carry_their_depth():
    from diffusion_image_editing_tpu_torch.utils import logging as L

    unet, _ = _pair()
    x, t, ctx, pooled, ids = _inputs()
    with L.tracing() as spans, torch.no_grad():
        unet(x, t, ctx, added_cond={"text_embeds": pooled, "time_ids": ids})
    depths = [s["index"] for s in spans if s["name"] == "models.unet.transformer"]
    assert depths == [2, 2, 2, 2]  # level 1's down stack, the mid block, two up stacks
    assert not L._ON


def test_trace_script_reads_transformer_ms_and_blocks_per_call():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "scripts" / "torch_trace_cell.py"
    spec = importlib.util.spec_from_file_location("torch_trace_cell", path)
    S = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(S)

    class Trace:
        def range_device_s(self, name):
            return {"die.models.unet": 0.3, "die.models.unet.transformer": 0.2}.get(name, 0.0)

        def range_count(self, name):
            return {"die.models.unet": 2, "die.models.unet.transformer": 22}.get(name, 0)

        def idle_gaps(self, n=10):
            return []

    def span(i, name, start):
        return dict(id=i, name=name, parent=None, request=1, thread=1, start_ns=start,
                    end_ns=start + 5, host_syncs=0)

    traced = [span(0, "engine.step", 0), span(1, "models.unet", 1), span(2, "engine.step", 10),
              span(3, "models.unet", 11)]
    counts = {"engine.steps": 2, "models.unet.transformer_blocks": 140}
    out = S.read_spans(traced, 1, {}, counts, {}, Trace(), lambda f, b: 0.0)
    assert out["xfmr_ms"] == pytest.approx(100.0)
    assert out["transformer_blocks_per_call"] == 70.0
    assert out["unet_ms"] == pytest.approx(150.0)
