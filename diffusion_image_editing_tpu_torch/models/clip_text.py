"""CLIP text encoder (SD's prompt conditioner) in torch: the port of
`models/clip_text.py` with `transformers.CLIPTextModel`'s parameter names
(`text_model.embeddings.token_embedding.weight`,
`text_model.encoder.layers.N.self_attn.q_proj.weight`, ...), so an HF state
dict loads with a plain `load_state_dict`.

A causal pre-LayerNorm transformer returning the final-LayerNorm'd last
hidden state in f32. Its attention is causal, which the port's `attention`
serves with the plain version on every device (as the JAX package does):
this module brings no kernel.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn

from ..core.device import resolve_device
from ..ops.attention import attention


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"


CLIP_VIT_L_14_TEXT = CLIPTextConfig()  # SD-1.x text encoder, 123 M parameters

TINY_CLIP_TEXT = CLIPTextConfig(
    vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
    intermediate_size=64, max_position_embeddings=16,
)


def _act(x: torch.Tensor, name: str) -> torch.Tensor:
    if name == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    if name == "gelu":
        return nn.functional.gelu(x)
    raise ValueError(f"Unknown activation {name!r}")


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, **factory):
        super().__init__()
        d = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.q_proj = nn.Linear(d, d, **factory)
        self.k_proj = nn.Linear(d, d, **factory)
        self.v_proj = nn.Linear(d, d, **factory)
        self.out_proj = nn.Linear(d, d, **factory)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        hd = d // self.num_heads
        q = self.q_proj(x).reshape(b, s, self.num_heads, hd)
        k = self.k_proj(x).reshape(b, s, self.num_heads, hd)
        v = self.v_proj(x).reshape(b, s, self.num_heads, hd)
        out = attention(q, k, v, scale=hd ** -0.5, causal=True)
        return self.out_proj(out.reshape(b, s, d))


class CLIPMLP(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, **factory):
        super().__init__()
        self.act = cfg.hidden_act
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size, **factory)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size, **factory)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(_act(self.fc1(x), self.act))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, **factory):
        super().__init__()
        self.self_attn = CLIPAttention(cfg, **factory)
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps, **factory)
        self.mlp = CLIPMLP(cfg, **factory)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps, **factory)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, **factory):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size, **factory)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size,
                                               **factory)


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, **factory):
        super().__init__()
        self.layers = nn.ModuleList([CLIPEncoderLayer(cfg, **factory)
                                     for _ in range(cfg.num_layers)])


class _TextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, **factory):
        super().__init__()
        self.embeddings = _Embeddings(cfg, **factory)
        self.encoder = _Encoder(cfg, **factory)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps,
                                             **factory)


class CLIPTextEncoder(nn.Module):
    """Token ids (B, L) -> last hidden state (B, L, hidden) in f32, the
    `text_encoder(input_ids)[0]` contract. Built on `device` (None = CUDA,
    raising without it) with parameters in `dtype`, the compute dtype."""

    def __init__(self, config: CLIPTextConfig, device=None, dtype=torch.float32):
        super().__init__()
        self.config = config
        self.text_model = _TextTransformer(config, device=resolve_device(device), dtype=dtype)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        tm = self.text_model
        ids = torch.as_tensor(input_ids, device=tm.final_layer_norm.weight.device).long()
        positions = torch.arange(ids.shape[1], device=ids.device)
        h = tm.embeddings.token_embedding(ids) + tm.embeddings.position_embedding(positions)[None]
        for layer in tm.encoder.layers:
            h = layer(h)
        return tm.final_layer_norm(h).float()
