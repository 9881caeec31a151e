"""Run configurations: the port's own copy of the JAX package's
`utils/config.py`. One dataclass per concern, each serialised to and from
JSON (the same JSON as the JAX package's) for reproducible runs.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Sequence, Tuple


@dataclasses.dataclass
class ModelSpec:
    """Which diffusion model family + where its weights live."""

    family: str = "ddpm"  # ddpm | ldm | sd
    checkpoint_dir: Optional[str] = None  # HF-layout directory for port.py
    sample_clipping: bool = True  # clip pred-x0 to [-1, 1] in generation
    dtype: str = "float32"  # float32 | bfloat16


@dataclasses.dataclass
class EditConfig:
    """Everything `EditPipeline` and `AttrFunc` take as separate arguments."""

    num_inference_steps: int = 50
    eta: float = 0.0
    cfg_scale: float = 3.5
    prompt: str = ""
    inversion_method: str = "ddim"  # ddim | ddpm
    t_skip: Optional[int] = 36
    resynthesize: bool = False
    classes: Optional[Tuple[int, ...]] = None
    dilate_mask: bool = False
    # guidance
    attr_func: Optional[str] = None  # registry name
    loss_scale: float = 1.0
    t1: int = 0
    t2: int = 50
    nudge_xt: bool = True
    nudge_zt: bool = False
    use_mask: bool = False
    mask_attr_grad: bool = False
    mask_pred_original_sample: bool = False
    lambda_: float = 0.01
    metric: Optional[str] = None  # l2 | lpips
    seed: int = 0


@dataclasses.dataclass
class MeshConfig:
    axis_names: Tuple[str, ...] = ("data",)
    shape: Optional[Tuple[int, ...]] = None


def to_json(cfg) -> str:
    return json.dumps(dataclasses.asdict(cfg), indent=2)


def from_json(cls, text: str):
    data = json.loads(text)
    fields = {f.name for f in dataclasses.fields(cls)}
    clean = {}
    for k, v in data.items():
        if k in fields:
            clean[k] = tuple(v) if isinstance(v, list) else v
    return cls(**clean)
