"""The port's `generate` and `edit` subcommands on the CPU (`--device cpu`),
from a TINY SD checkpoint directory the test writes, each writing a PNG;
without `--device` they ask for CUDA and raise here; the options of later
slices exit naming their ROADMAP item. The host-side image codecs they use
against the JAX package's, exactly."""

import numpy as np
import pytest
import torch
from PIL import Image

from diffusion_image_editing_tpu_torch import cli
from tests.torch_port_helpers import write_tiny_sd_dir


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    root = tmp_path_factory.mktemp("sd")
    write_tiny_sd_dir(str(root), "bin")
    img = np.random.default_rng(0).integers(0, 255, (40, 40, 3), dtype=np.uint8)
    Image.fromarray(img).save(root / "face.png")
    return root


def test_generate_writes_a_png(ckpt, tmp_path, capsys):
    prefix = str(tmp_path / "g")
    assert cli.main(["generate", "--device", "cpu", "--checkpoint-dir", str(ckpt), "--steps",
                     "2", "--prompt", "the red cat", "--num-images", "2",
                     "--out-prefix", prefix]) == 0
    for i in range(2):
        with Image.open(f"{prefix}_{i}.png") as im:
            assert im.size == (16, 16) and im.mode == "RGB"
    assert f"{prefix}_1.png" in capsys.readouterr().out


def test_ddim_fused_resynthesized_edit_writes_a_png(ckpt, tmp_path):
    out = tmp_path / "e.png"
    assert cli.main(["edit", "--device", "cpu", "--checkpoint-dir", str(ckpt), "--image",
                     str(ckpt / "face.png"), "--steps", "2", "--inversion-method", "ddim",
                     "--edit-mode", "fused", "--resynthesize", "--attr-func",
                     "SingleColorAttrFunc", "--t2", "2", "--out", str(out)]) == 0
    with Image.open(out) as im:
        assert im.size == (32, 32)
    arr = np.asarray(Image.open(out))
    assert arr.std() > 0


def test_ddpm_edit_writes_a_png(ckpt, tmp_path):
    out = tmp_path / "d.png"
    assert cli.main(["edit", "--device", "cpu", "--checkpoint-dir", str(ckpt), "--image",
                     str(ckpt / "face.png"), "--steps", "3", "--inversion-method", "ddpm",
                     "--eta", "1", "--t-skip", "1", "--image-size", "32",
                     "--attr-func", "SingleColorAttrFunc", "--out", str(out)]) == 0
    assert out.exists()


def test_without_device_the_cli_asks_for_cuda(ckpt, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["generate", "--checkpoint-dir", str(ckpt), "--steps", "2",
                  "--out-prefix", str(tmp_path / "g")])


@pytest.mark.parametrize("cmd,flags,item", [
    ("edit", ["--align"], "item 20"), ("edit", ["--landmarks", "lm.dat"], "item 20"),
    ("edit", ["--classes", "17"], "item 15a"), ("edit", ["--guidance-codec", "proxy"], "item 16"),
    ("edit", ["--encoder-reuse", "2"], "item 16"), ("edit", ["--shard", "cfg2xsp4"], "item 18"),
    ("edit", ["--bisenet-ckpt", "b.pth"], "item 15a"), ("edit", ["--dilate-mask"], "item 15a"),
    ("generate", ["--sample-clipping"], "item 14"),
    ("generate", ["--no-sample-clipping"], "item 14"),
])
def test_later_options_exit_naming_their_item(ckpt, cmd, flags, item):
    image = ["--image", str(ckpt / "face.png")] if cmd == "edit" else []
    with pytest.raises(SystemExit, match=item):
        cli.main([cmd, "--device", "cpu", "--checkpoint-dir", str(ckpt)] + image + flags)


def test_empty_prompt_runs_cfg_between_two_empty_prompts(ckpt, tmp_path):
    """The default `--prompt ""` is the empty prompt's ids, paired with the
    empty prompt by `SD.prep_text` (the JAX package's CLI passes no ids)."""
    from diffusion_image_editing_tpu_torch.host.transforms import tensors_to_pils
    from diffusion_image_editing_tpu_torch.pipeline import create_diffusion_model

    prefix = str(tmp_path / "g")
    assert cli.main(["generate", "--device", "cpu", "--checkpoint-dir", str(ckpt), "--steps",
                     "2", "--out-prefix", prefix]) == 0
    w = create_diffusion_model("sd", checkpoint_dir=str(ckpt), num_inference_steps=2,
                               device="cpu")
    empty = torch.tensor(w.tokenizer.encode(""))
    imgs, *_ = w.generate_images(num_inference_steps=2, seed=0, prompt_ids=empty)
    np.testing.assert_array_equal(np.asarray(Image.open(f"{prefix}_0.png")),
                                  np.asarray(tensors_to_pils(imgs)[0]))


def test_sd_needs_a_tokenizer(tmp_path):
    with pytest.raises(SystemExit, match="tokenizer"):
        cli.main(["generate", "--device", "cpu", "--checkpoint-dir", str(tmp_path)])
    with pytest.raises(NotImplementedError, match="item 14"):
        cli.main(["generate", "--device", "cpu", "--family", "ddpm"])


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
