"""The port's CLIP tokenizer and text encoder against the JAX package's.

The tokenizer: the same synthetic vocabulary and merges, written as an HF
tokenizer directory (vocab.json + merges.txt) and in openai's
bpe_simple_vocab form (plain and gzipped), give the same ids in both
packages on several strings; ids are compared exactly.

The encoder: TINY_CLIP_TEXT with seeded Flax params carried across by
`state_dict_from_jax(..., "clip_text")`, f32 on both sides, summation order
only: rtol 1e-4, atol 1e-5 (as tests/test_torch_models.py).
"""

import gzip
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_image_editing_tpu.host.tokenizer import CLIPTokenizer as JTokenizer
from diffusion_image_editing_tpu.models.clip_text import TINY_CLIP_TEXT as J_TINY
from diffusion_image_editing_tpu.models.clip_text import CLIPTextEncoder as JCLIP
from diffusion_image_editing_tpu_torch.host.tokenizer import CLIPTokenizer, bytes_to_unicode
from diffusion_image_editing_tpu_torch.models import (
    CLIP_VIT_L_14_TEXT, TINY_CLIP_TEXT, CLIPTextEncoder, state_dict_from_jax)
from tests.torch_port_helpers import jax_params

FWD_TOL = dict(rtol=1e-4, atol=1e-5)
MERGES = [("h", "e"), ("l", "l"), ("he", "ll"), ("hell", "o</w>"), ("t", "h"), ("th", "e</w>"),
          ("a", "n"), ("an", "d</w>"), ("c", "a"), ("ca", "t</w>"), ("r", "e"), ("re", "d</w>")]
STRINGS = ["", "hello", "Hello, the cat and the RED hat!", "a photo of a red-haired cat",
           "x" * 120, "naïve café &amp; 3 dogs's"]


def _vocab():
    byte_vocab = list(bytes_to_unicode().values())
    tokens = byte_vocab + [v + "</w>" for v in byte_vocab]
    tokens += ["".join(m) for m in MERGES] + ["<|startoftext|>", "<|endoftext|>"]
    return {t: i for i, t in enumerate(tokens)}


@pytest.fixture(scope="module")
def tokenizer_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("tok")
    hf = root / "tokenizer"
    hf.mkdir()
    (hf / "vocab.json").write_text(json.dumps(_vocab()))
    (hf / "merges.txt").write_text("#version: 0.2\n" + "\n".join(" ".join(m) for m in MERGES))
    lines = "bpe_simple_vocab\n" + "\n".join(" ".join(m) for m in MERGES) + "\n"
    plain = root / "bpe_simple_vocab.txt"
    plain.write_text(lines)
    packed = root / "bpe_simple_vocab.txt.gz"
    with gzip.open(packed, "wt", encoding="utf-8") as f:
        f.write(lines)
    return {"hf": str(hf), "openai": str(plain), "openai_gz": str(packed)}


@pytest.mark.parametrize("form", ["hf", "openai", "openai_gz"])
def test_tokenizer_ids_match_jax(tokenizer_files, form):
    path = tokenizer_files[form]
    tok, jtok = CLIPTokenizer.from_pretrained(path), JTokenizer.from_pretrained(path)
    for text in STRINGS:
        ids = tok.encode(text)
        assert ids == jtok.encode(text), text
        assert len(ids) == 77 and ids[0] == tok.bos and tok.eos in ids
    assert tok.encode("hello", pad=False) == [tok.bos, tok.encoder["hello</w>"], tok.eos]
    np.testing.assert_array_equal(tok(STRINGS), jtok(STRINGS))
    assert tok(STRINGS).dtype == np.int32


def test_tokenizer_without_files_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        CLIPTokenizer.from_pretrained(str(tmp_path))


@pytest.fixture(scope="module")
def clip_pair():
    jm = JCLIP(J_TINY)
    params = jax_params(jm, 3, jnp.zeros((1, 16), jnp.int32))
    tm = CLIPTextEncoder(TINY_CLIP_TEXT, device="cpu")
    tm.load_state_dict(state_dict_from_jax(params, "clip_text"))
    return jm, params, tm


@pytest.mark.parametrize("length", [16, 7])
def test_clip_matches_jax(clip_pair, length):
    jm, params, tm = clip_pair
    ids = np.random.default_rng(length).integers(0, TINY_CLIP_TEXT.vocab_size, (2, length),
                                                 dtype=np.int32)
    ref = np.asarray(jm.apply(params, jnp.asarray(ids)))
    with torch.no_grad():
        out = tm(torch.from_numpy(ids))
    assert out.dtype == torch.float32 and tuple(out.shape) == (2, length, 32)
    np.testing.assert_allclose(out.numpy(), ref, **FWD_TOL)


def test_clip_is_causal(clip_pair):
    """A token changed at position k leaves the states before k as they were."""
    _, _, tm = clip_pair
    ids = torch.arange(16)[None].repeat(2, 1)
    ids[1, 9] = 100
    with torch.no_grad():
        out = tm(ids)
    torch.testing.assert_close(out[1, :9], out[0, :9], rtol=0, atol=0)
    assert (out[1, 9:] - out[0, 9:]).abs().max() > 1e-3


def test_clip_uses_transformers_names_and_sizes():
    keys = CLIPTextEncoder(TINY_CLIP_TEXT, device="cpu").state_dict()
    assert "text_model.embeddings.token_embedding.weight" in keys
    assert "text_model.encoder.layers.1.self_attn.q_proj.weight" in keys
    assert "text_model.encoder.layers.0.mlp.fc2.bias" in keys
    assert "text_model.final_layer_norm.weight" in keys
    full = CLIPTextEncoder(CLIP_VIT_L_14_TEXT, device="meta")
    n = sum(p.numel() for p in full.parameters())
    assert 122e6 < n < 124e6, n
    assert CLIP_VIT_L_14_TEXT.hidden_size // CLIP_VIT_L_14_TEXT.num_heads == 64


def test_bf16_clip_runs_in_bf16(clip_pair):
    _, _, tm = clip_pair
    ids = torch.arange(16)[None]
    half = CLIPTextEncoder(TINY_CLIP_TEXT, device="cpu", dtype=torch.bfloat16)
    half.load_state_dict(tm.state_dict())
    with torch.no_grad():
        ref, out = tm(ids), half(ids)
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    assert (out - ref).abs().max() < 0.1 * ref.abs().max()
