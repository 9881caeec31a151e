"""The port's subcommands on the CPU (`--device cpu`): `generate` and `edit`
from a TINY SD checkpoint directory the test writes (`--family sd`; the
default family is ddpm, as the JAX CLI's), each writing a PNG; without
`--device` they ask for CUDA and raise here; the options of later slices
exit naming their ROADMAP item. The masked segmentation edit runs from a
TINY face-parsing checkpoint the test writes, or from seeded random
weights; `edit --align` aligns the face from the parsing or from dlib's
landmarks. `metrics` (with and without `--attr-func`) on a TINY DDPM
directory prints what the Python API computes; `seg-eval` writes the
overlays of a seg-train checkpoint. The host-side image codecs they use
against the JAX package's, exactly."""

import numpy as np
import pytest
import torch
from PIL import Image

from diffusion_image_editing_tpu_torch import cli
from tests.torch_port_helpers import write_bisenet_checkpoint, write_tiny_sd_dir


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    root = tmp_path_factory.mktemp("sd")
    write_tiny_sd_dir(str(root), "bin")
    img = np.random.default_rng(0).integers(0, 255, (40, 40, 3), dtype=np.uint8)
    Image.fromarray(img).save(root / "face.png")
    return root


def test_generate_writes_a_png(ckpt, tmp_path, capsys):
    prefix = str(tmp_path / "g")
    assert cli.main(["generate", "--device", "cpu", "--family", "sd", "--checkpoint-dir", str(ckpt),
                     "--steps", "2", "--prompt", "the red cat", "--num-images", "2",
                     "--out-prefix", prefix]) == 0
    for i in range(2):
        with Image.open(f"{prefix}_{i}.png") as im:
            assert im.size == (16, 16) and im.mode == "RGB"
    assert f"{prefix}_1.png" in capsys.readouterr().out


def test_ddim_fused_resynthesized_edit_writes_a_png(ckpt, tmp_path):
    out = tmp_path / "e.png"
    assert cli.main(["edit", "--device", "cpu", "--family", "sd", "--checkpoint-dir", str(ckpt),
                     "--image", str(ckpt / "face.png"),
                     "--steps", "2", "--inversion-method", "ddim",
                     "--edit-mode", "fused", "--resynthesize", "--attr-func",
                     "SingleColorAttrFunc", "--t2", "2", "--out", str(out)]) == 0
    with Image.open(out) as im:
        assert im.size == (32, 32)
    arr = np.asarray(Image.open(out))
    assert arr.std() > 0


def test_ddpm_edit_writes_a_png(ckpt, tmp_path):
    out = tmp_path / "d.png"
    assert cli.main(["edit", "--device", "cpu", "--family", "sd", "--checkpoint-dir", str(ckpt),
                     "--image", str(ckpt / "face.png"),
                     "--steps", "3", "--inversion-method", "ddpm",
                     "--eta", "1", "--t-skip", "1", "--image-size", "32",
                     "--attr-func", "SingleColorAttrFunc", "--out", str(out)]) == 0
    assert out.exists()


def test_masked_seg_edit_writes_a_png(ckpt, tmp_path, capsys):
    """`--classes 17 --dilate-mask --bisenet-ckpt F --resynthesize`: the
    hair mask from a face-parsing checkpoint, resynthesis inside it. The
    mask is made at the UNet's sample size (8 for the TINY UNet), so the
    image is 16 px."""
    seg = tmp_path / "79999_iter.pth"
    write_bisenet_checkpoint(str(seg), seed=0, width=64)
    out = tmp_path / "s.png"
    assert cli.main(["edit", "--device", "cpu", "--family", "sd", "--checkpoint-dir", str(ckpt),
                     "--image", str(ckpt / "face.png"), "--image-size", "16", "--steps", "2",
                     "--classes", "17", "--dilate-mask", "--bisenet-ckpt", str(seg),
                     "--resynthesize", "--out", str(out)]) == 0
    arr = np.asarray(Image.open(out))
    assert arr.shape == (16, 16, 3) and np.isfinite(arr).all() and arr.std() > 0
    assert "random-init" not in capsys.readouterr().err


def test_classes_without_a_checkpoint_run_on_random_weights(ckpt, tmp_path, capsys):
    out = tmp_path / "r.png"
    assert cli.main(["edit", "--device", "cpu", "--family", "sd", "--checkpoint-dir", str(ckpt),
                     "--image", str(ckpt / "face.png"),
                     "--image-size", "16", "--steps", "2", "--classes",
                     "17", "1",
                     "--resynthesize", "--out", str(out)]) == 0
    assert out.exists()
    assert "WARNING: random-init weights" in capsys.readouterr().err


def test_classes_out_of_range_are_refused(ckpt, tmp_path):
    seg = tmp_path / "seg.pth"
    write_bisenet_checkpoint(str(seg), seed=0, width=64)
    with pytest.raises(ValueError, match="class 19 out of range"):
        cli.main(["edit", "--device", "cpu", "--family", "sd", "--checkpoint-dir", str(ckpt),
                  "--image", str(ckpt / "face.png"),
                  "--steps", "2", "--classes", "19", "--bisenet-ckpt",
                  str(seg), "--out", str(tmp_path / "x.png")])


def test_without_device_the_cli_asks_for_cuda(ckpt, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["generate", "--family", "sd", "--checkpoint-dir", str(ckpt), "--steps", "2",
                  "--out-prefix", str(tmp_path / "g")])


@pytest.mark.parametrize("cmd,flags", [
    ("edit", ["--guidance-codec", "proxy"]), ("edit", ["--encoder-reuse", "2"]),
    ("generate", ["--encoder-reuse", "3"]),
])
def test_opt_in_accelerations_run(ckpt, cmd, flags, tmp_path, capsys):
    """`--guidance-codec proxy` and `--encoder-reuse k` run and write their
    image."""
    from PIL import Image

    out = tmp_path / "o"
    tail = (["--image", str(ckpt / "face.png"), "--attr-func", "SingleColorAttrFunc",
             "--out", f"{out}.png"] if cmd == "edit" else ["--out-prefix", str(out)])
    assert cli.main([cmd, "--device", "cpu", "--family", "sd", "--checkpoint-dir", str(ckpt),
                     "--steps", "3"] + tail + flags) == 0
    path = capsys.readouterr().out.split()[-1]
    # edit: the codec's 32 px; generate: the TINY UNet's 8 x 8 latent decoded
    assert Image.open(path).size == ((32, 32) if cmd == "edit" else (16, 16))


@pytest.mark.parametrize("cmd,flags,item", [
    # Every --shard spec is ported; it needs as many ranks (torchrun) as its
    # sizes multiply to, and one process has one. Runs on two and four gloo
    # ranks: tests/test_torch_spatial.py::test_cli_shard_runs_on_gloo_ranks.
    ("edit", ["--shard", "cfg2xsp4"], "needs 8 devices, have 1"),
    ("generate", ["--shard", "sp8"], "needs 8 devices, have 1"),
    ("edit", ["--shard", "cfg2"], "needs 2 devices, have 1"),
    ("generate", ["--shard", "cfg2"], "needs 2 devices, have 1"),
])
def test_later_options_exit_naming_their_item(ckpt, cmd, flags, item):
    image = ["--image", str(ckpt / "face.png")] if cmd == "edit" else []
    with pytest.raises(SystemExit, match=item):
        cli.main([cmd, "--device", "cpu", "--family", "sd", "--checkpoint-dir", str(ckpt)]
                 + image + flags)


def test_empty_prompt_runs_cfg_between_two_empty_prompts(ckpt, tmp_path):
    """The default `--prompt ""` is the empty prompt's ids, paired with the
    empty prompt by `SD.prep_text` (the JAX package's CLI passes no ids)."""
    from diffusion_image_editing_tpu_torch.host.transforms import tensors_to_pils
    from diffusion_image_editing_tpu_torch.pipeline import create_diffusion_model

    prefix = str(tmp_path / "g")
    assert cli.main(["generate", "--device", "cpu", "--family", "sd", "--checkpoint-dir",
                     str(ckpt), "--steps", "2", "--out-prefix", prefix]) == 0
    w = create_diffusion_model("sd", checkpoint_dir=str(ckpt), num_inference_steps=2,
                               device="cpu")
    empty = torch.tensor(w.tokenizer.encode(""))
    imgs, *_ = w.generate_images(num_inference_steps=2, seed=0, prompt_ids=empty)
    np.testing.assert_array_equal(np.asarray(Image.open(f"{prefix}_0.png")),
                                  np.asarray(tensors_to_pils(imgs)[0]))


def test_sd_needs_a_tokenizer(tmp_path):
    with pytest.raises(SystemExit, match="tokenizer"):
        cli.main(["generate", "--device", "cpu", "--family", "sd", "--checkpoint-dir",
                  str(tmp_path)])
    # DDPM takes no prompt and reads unet/ (tests/test_torch_families.py)
    with pytest.raises(FileNotFoundError, match="unet"):
        cli.main(["generate", "--device", "cpu", "--family", "ddpm", "--checkpoint-dir",
                  str(tmp_path)])


def test_transforms_match_jax():
    """The port's NCHW codecs against the JAX package's NHWC ones: the same
    PIL image in, the same pixels out."""
    from diffusion_image_editing_tpu.host import transforms as J
    from diffusion_image_editing_tpu_torch.host import transforms as T

    rng = np.random.default_rng(1)
    pils = [Image.fromarray(rng.integers(0, 255, (12, 10, 3), dtype=np.uint8)) for _ in range(2)]
    for src in (pils[0], pils):
        t, j = T.pil_to_tensor(src), J.pil_to_array(src)
        np.testing.assert_array_equal(t.numpy(), j.transpose(0, 3, 1, 2))
    x = rng.uniform(-1.2, 1.2, (1, 3, 12, 10)).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(T.tensor_to_pil(torch.from_numpy(x))),
                                  np.asarray(J.array_to_pil(x.transpose(0, 2, 3, 1))))
    mask = rng.integers(0, 2, (12, 10)).astype(np.float32) * 255
    np.testing.assert_array_equal(np.asarray(T.tensor_to_pil(mask)),
                                  np.asarray(J.array_to_pil(mask)))
    two = np.concatenate([x, -x])
    for a, b in zip(T.tensors_to_pils(torch.from_numpy(two)),
                    J.arrays_to_pils(two.transpose(0, 2, 3, 1))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with pytest.raises(ValueError):
        T.pil_to_tensor("not an image")


# ---------------------------------------------------------------------------
# The family default, edit --align, metrics and seg-eval
# ---------------------------------------------------------------------------

SHARED = {"generate": ["family", "checkpoint_dir", "steps", "seed", "encoder_reuse", "shard",
                       "num_images", "eta", "prompt", "cfg_scale", "sample_clipping",
                       "out_prefix"],
          "edit": ["family", "steps", "align", "landmarks", "eta", "inversion_method", "t_skip",
                   "attr_func", "loss_scale", "t1", "t2", "color_target", "color_idx",
                   "classes", "bisenet_ckpt", "dilate_mask", "resynthesize", "edit_mode",
                   "guidance_codec", "guidance_stride", "out"],
          "metrics": ["family", "steps", "seed", "n", "attr_func", "anygan_ckpt", "loss_scale",
                      "t1", "t2", "color_target", "color_idx", "eta", "inversion", "t_skip",
                      "resynthesize"],
          "seg-eval": ["out_dir", "ckpt_dir", "width"]}


@pytest.mark.parametrize("cmd", sorted(SHARED))
def test_defaults_are_the_jax_cli_s(cmd, monkeypatch):
    """The JAX CLI's parsed defaults (its command is replaced by a recorder)
    against the port's, the family (ddpm) among them."""
    import diffusion_image_editing_tpu.cli as J
    import diffusion_image_editing_tpu.utils.compcache as compcache

    seen = {}
    fn = {"generate": "cmd_generate", "edit": "cmd_edit", "metrics": "cmd_metrics",
          "seg-eval": "cmd_seg_eval"}[cmd]
    monkeypatch.setattr(J, fn, lambda args: seen.update(vars(args)))
    monkeypatch.setattr(compcache, "enable_persistent_cache", lambda: None)
    required = {"edit": ["--image", "x.png"], "seg-eval": ["--image-dir", "d"]}.get(cmd, [])
    J.main([cmd] + required)
    port = vars(cli.build_parser().parse_args([cmd] + required))
    assert {k: port[k] for k in SHARED[cmd]} == {k: seen[k] for k in SHARED[cmd]}
    if cmd != "seg-eval":
        assert port["family"] == "ddpm"


def test_generate_without_a_family_writes_ddpm_images(tmp_path, monkeypatch, capsys):
    """`generate --device cpu --steps 2`: the DDPM family from seeded random
    weights (a TINY UNet2D here in place of the 256 px one), as the JAX CLI."""
    from diffusion_image_editing_tpu_torch import models as TM
    from diffusion_image_editing_tpu_torch.host.transforms import tensors_to_pils
    from diffusion_image_editing_tpu_torch.pipeline import create_diffusion_model, factory

    monkeypatch.setattr(factory, "DDPM_CELEBAHQ_256", TM.TINY_UNET2D)
    prefix = str(tmp_path / "g")
    assert cli.main(["generate", "--device", "cpu", "--steps", "2", "--out-prefix", prefix]) == 0
    assert "random-init" in capsys.readouterr().err
    w = create_diffusion_model("ddpm", num_inference_steps=2, device="cpu")
    imgs, *_ = w.generate_images(num_inference_steps=2, seed=0)
    got = np.asarray(Image.open(f"{prefix}_0.png"))
    assert got.shape == (16, 16, 3)
    np.testing.assert_array_equal(got, np.asarray(tensors_to_pils(imgs)[0]))


@pytest.fixture(scope="module")
def ddpm_dir(tmp_path_factory):
    from tests.torch_port_helpers import write_tiny_ddpm_dir

    root = tmp_path_factory.mktemp("ddpm")
    write_tiny_ddpm_dir(str(root))
    rng = np.random.default_rng(3)
    Image.fromarray(rng.integers(0, 255, (96, 128, 3), dtype=np.uint8)).save(root / "face.png")
    return root


def _parsing_double(monkeypatch, size=512):
    """`create_segmentation_model` replaced by a parsing with two eyes and a
    mouth (random BiSeNet weights parse no face)."""
    from diffusion_image_editing_tpu_torch import pipeline
    from tests.test_torch_alignment import face_parsing

    parsing = torch.from_numpy(face_parsing(size))
    calls = []

    def seg_fn(img):
        calls.append(tuple(img.shape))
        return parsing

    monkeypatch.setattr(pipeline, "create_segmentation_model", lambda *a, **k: seg_fn)
    return parsing.numpy(), calls


def test_edit_align_from_the_parsing(ddpm_dir, tmp_path, monkeypatch):
    """`--align` without `--landmarks`: the face aligned from the parsing
    of the whole photo (as the JAX CLI), then edited at the family's 16 px."""
    from diffusion_image_editing_tpu.host.alignment import align_from_parsing as j_align
    from diffusion_image_editing_tpu_torch import pipeline

    parsing, calls = _parsing_double(monkeypatch)
    photo = Image.open(ddpm_dir / "face.png").convert("RGB")
    args = cli.build_parser().parse_args(["edit", "--image", str(ddpm_dir / "face.png"),
                                          "--align"])
    img = cli._load_image(args, 16, pipeline.create_segmentation_model())
    assert calls == [(1, 3, 96, 128)]
    np.testing.assert_array_equal(
        img.numpy(), np.asarray(j_align(photo, parsing, output_size=16), np.float32).transpose(
            2, 0, 1)[None] / 127.5 - 1.0)
    out = tmp_path / "a.png"
    assert cli.main(["edit", "--device", "cpu", "--checkpoint-dir", str(ddpm_dir), "--image",
                     str(ddpm_dir / "face.png"), "--steps", "2", "--align", "--attr-func",
                     "SingleColorAttrFunc", "--out", str(out)]) == 0
    assert np.asarray(Image.open(out)).shape == (16, 16, 3)


def test_edit_align_with_dlib_landmarks(ddpm_dir, tmp_path, monkeypatch):
    """`--align --landmarks PATH`: dlib's landmarks (a stand-in detector
    here), no segmentation model."""
    import diffusion_image_editing_tpu_torch.host.alignment as TA
    from tests.test_torch_alignment import face_parsing

    lm = TA.landmarks_from_parsing(face_parsing(96))
    monkeypatch.setattr(TA, "dlib_landmarker", lambda path: (lambda img: lm * [128 / 96, 1]))
    _, calls = _parsing_double(monkeypatch)
    out = tmp_path / "l.png"
    assert cli.main(["edit", "--device", "cpu", "--checkpoint-dir", str(ddpm_dir), "--image",
                     str(ddpm_dir / "face.png"), "--steps", "2", "--align", "--landmarks",
                     "shape_predictor_68_face_landmarks.dat", "--attr-func",
                     "SingleColorAttrFunc", "--out", str(out)]) == 0
    assert calls == [] and np.asarray(Image.open(out)).shape == (16, 16, 3)


def test_metrics_with_an_attribute_function(ddpm_dir, capsys):
    """The consistency and delta lines in the JAX CLI's format, as
    `run_attribute_evaluation` computes them with the seeded anyGAN."""
    from diffusion_image_editing_tpu_torch.evals import run_attribute_evaluation
    from diffusion_image_editing_tpu_torch.guidance import SingleColorAttrFunc
    from diffusion_image_editing_tpu_torch.pipeline import (
        EditPipeline, create_diffusion_model, get_pretrained_anygan)

    assert cli.main(["metrics", "--device", "cpu", "--checkpoint-dir", str(ddpm_dir),
                     "--steps", "3", "--n", "2", "--attr-func", "SingleColorAttrFunc",
                     "--t2", "3", "--loss-scale", "50"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    w = create_diffusion_model("ddpm", sample_clipping=False, checkpoint_dir=str(ddpm_dir),
                               num_inference_steps=3, device="cpu")
    predict, _ = get_pretrained_anygan(device="cpu")
    res = run_attribute_evaluation(
        w, EditPipeline(w), predict,
        SingleColorAttrFunc(loss_scale=50.0, t1=0, t2=3, target=0.9, color_idx=0),
        n_samples=2, num_inference_steps=3)
    want = [f"{name} {pct:.2f}%" for name, pct in res["attribute_consistency"].items()]
    want += [f"{idx} {name}: {delta:+.3f}" for idx, name, delta in res["score_deltas"]]
    assert lines == want and len(lines) == 80


def test_metrics_round_trip(ddpm_dir, capsys):
    """Without `--attr-func`: the DDPM inversion round trip's PSNR and MSE."""
    import ast

    assert cli.main(["metrics", "--device", "cpu", "--checkpoint-dir", str(ddpm_dir),
                     "--steps", "3", "--n", "2"]) == 0
    res = ast.literal_eval(capsys.readouterr().out.strip())
    assert set(res) == {"psnr", "mse"} and res["psnr"] > 20 and 0 <= res["mse"] < 0.01


def test_seg_eval_writes_overlays(tmp_path):
    """From a seg-train checkpoint directory at width 8."""
    from diffusion_image_editing_tpu_torch.seg import TrainConfig, create_train_state
    from diffusion_image_editing_tpu_torch.seg.evaluate import vis_parsing_maps

    ckpt = tmp_path / "ckpt"
    assert cli.main(["seg-train", "--device", "cpu", "--image-size", "32", "--batch-size", "2",
                     "--width", "8", "--num-steps", "1", "--prefetch", "0", "--num-workers",
                     "0", "--ckpt-dir", str(ckpt)]) == 0
    imgs = tmp_path / "imgs"
    imgs.mkdir()
    Image.fromarray(np.random.default_rng(4).integers(0, 255, (40, 40, 3), dtype=np.uint8)
                    ).save(imgs / "a.png")
    out = tmp_path / "vis"
    assert cli.main(["seg-eval", "--device", "cpu", "--image-dir", str(imgs), "--out-dir",
                     str(out), "--ckpt-dir", str(ckpt), "--width", "8"]) == 0
    from diffusion_image_editing_tpu_torch.host.transforms import pil_to_tensor
    from diffusion_image_editing_tpu_torch.models import SegmentationModel
    from diffusion_image_editing_tpu_torch.seg import restore_checkpoint

    model, state = create_train_state(TrainConfig(width=8), device="cpu")
    restore_checkpoint(str(ckpt), state)
    assert state.step == 1
    img512 = Image.open(imgs / "a.png").convert("RGB").resize((512, 512), Image.BILINEAR)
    parsing = SegmentationModel(model)(pil_to_tensor(img512)).numpy()
    np.testing.assert_array_equal(np.asarray(Image.open(out / "a.png")),
                                  vis_parsing_maps(img512, parsing))
