"""BiSeNet training: OHEM 3-head loss, warmup + poly SGD over four parameter
groups, torch checkpoints with resume, on one device or data-parallel over
a `dp` mesh axis. The port of the JAX package's `seg/train.py`.

A step takes an NHWC numpy batch from the data pipeline (or an NCHW
tensor), moves it to the model's device, normalises a uint8 batch there,
runs the model in training mode (its norms update their running
statistics), and takes one SGD step at the schedule's learning rate.

Data-parallel (`make_sharded_train_step`, the reference's DDP): each rank
steps on its share of the batch, then one all-reduce gives every rank the
mean over `dp` of the gradients, the loss and the running statistics, as
the JAX package's `pmean`s do; parameters and optimizer state stay equal
on every rank. Norm statistics are each rank's own, or with
`norm="abn_sync"` the group's (synced ABN); synced ABN's weight and bias
gradients are the group's sums before that mean, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import os
import re
from pathlib import Path
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..core.device import resolve_device
from ..models.bisenet import BiSeNet
from ..parallel.mesh import is_first_rank, make_mesh, mean_over, shard_leading_axis
from .data import IMAGENET_MEAN, IMAGENET_STD
from .losses import ohem_ce_loss
from .optim import make_optimizer, set_learning_rate, warmup_poly_schedule


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Hyperparameters of the reference trainer (`Segmentation/train.py:56-103`)."""

    n_classes: int = 19
    image_size: int = 448
    batch_size_per_device: int = 16
    max_iter: int = 80000
    lr0: float = 1e-2
    momentum: float = 0.9
    weight_decay: float = 5e-4
    warmup_steps: int = 1000
    warmup_start_lr: float = 1e-5
    power: float = 0.9
    ohem_thresh: float = 0.7
    score_thres: float = 0.7
    norm: str = "bn"  # "bn" | "abn" | "abn_sync"
    width: int = 64
    ckpt_every: int = 5000
    # conv COMPUTE dtype ("float32" | "bfloat16"): parameters, norm
    # statistics and the loss stay f32 either way (mixed precision).
    compute_dtype: str = "float32"

    @property
    def n_min(self) -> int:
        return self.batch_size_per_device * self.image_size**2 // 16


@dataclasses.dataclass
class TrainState:
    """The model (weights and running statistics), its optimizer, the
    learning-rate schedule, and the number of steps taken."""

    model: BiSeNet
    optimizer: torch.optim.SGD
    schedule: Callable[[int], float]
    step: int = 0


def compute_dtype(cfg: TrainConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype in ("bf16", "bfloat16") else torch.float32


def create_model(cfg: TrainConfig, device=None, axis_name=None) -> BiSeNet:
    """The BiSeNet of `cfg`; with `norm="abn_sync"`, its norms sync their
    statistics over `axis_name` (a process group or a 1-D mesh; none: one
    rank, the same as "abn")."""
    return BiSeNet(n_classes=cfg.n_classes, norm=cfg.norm, width=cfg.width,
                   dtype=compute_dtype(cfg), device=device, axis_name=axis_name)


def create_train_state(cfg: TrainConfig, seed: int = 0,
                       device: Optional[Union[str, torch.device]] = None, axis_name=None):
    """(model, state). The weights come from torch's initialisers under
    `seed`, drawn on the CPU, so they are the same on every device and
    every rank."""
    device = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = create_model(cfg, device="cpu", axis_name=axis_name)
    model.to(device)
    optimizer = make_optimizer(model, momentum=cfg.momentum, weight_decay=cfg.weight_decay)
    schedule = warmup_poly_schedule(cfg.lr0, cfg.warmup_steps, cfg.warmup_start_lr,
                                    cfg.max_iter, cfg.power)
    return model, TrainState(model, optimizer, schedule)


def _prep_batch(images, labels, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(images, labels) on `device`: numpy batches are NHWC and become NCHW;
    tensors are NCHW already. A uint8 batch is ImageNet-normalised on the
    device ((x / 255 - mean) / std in f32, the host pipeline's arithmetic),
    so the copy to the device carries 4x fewer bytes; a float batch passes
    through. Labels become int64."""
    if isinstance(images, np.ndarray):
        images = _to_device(torch.from_numpy(np.ascontiguousarray(images)), device)
        images = images.permute(0, 3, 1, 2)
    else:
        images = images.to(device)
    if images.dtype == torch.uint8:
        shape = (1, 3, 1, 1)
        mean = _to_device(torch.from_numpy(IMAGENET_MEAN), device).reshape(shape)
        std = _to_device(torch.from_numpy(IMAGENET_STD), device).reshape(shape)
        images = (images.float() / 255.0 - mean) / std
    labels = _to_device(torch.as_tensor(labels), device).long()
    return images.contiguous(), labels


def _to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host tensor on `device`; to a GPU through pinned memory without
    waiting, so the host goes on launching while the copy runs."""
    if device.type != "cuda" or t.is_cuda:
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _loss_and_grads(model: BiSeNet, cfg: TrainConfig, state: TrainState, images,
                    labels) -> torch.Tensor:
    """The sum of the three heads' OHEM losses on the batch, its gradients
    left in the parameters' `.grad`; the norms update their running
    statistics."""
    device = next(model.parameters()).device
    x, y = _prep_batch(images, labels, device)
    model.train()
    set_learning_rate(state.optimizer, state.schedule(state.step))
    state.optimizer.zero_grad(set_to_none=True)
    loss = sum(ohem_ce_loss(out, y, cfg.score_thres, cfg.n_min) for out in model(x))
    loss.backward()
    return loss.detach()


def make_train_step(model: BiSeNet, cfg: TrainConfig):
    """One SGD step on the sum of the three heads' OHEM losses. Returns
    `train_step(state, images, labels) -> (state, loss)`; it updates the
    state in place and returns the loss as a 0-d tensor on the device."""

    def train_step(state: TrainState, images, labels):
        loss = _loss_and_grads(model, cfg, state, images, labels)
        state.optimizer.step()
        state.step += 1
        return state, loss

    return train_step


def make_sharded_train_step(model: BiSeNet, cfg: TrainConfig, mesh: DeviceMesh):
    """The data-parallel step over the mesh's `dp` axis (the reference's DDP,
    the JAX package's `shard_map` step): this rank's forward and backward
    on its share of the batch (`shard_batch`), then the mean over the
    `dp` ranks of every gradient, the loss and the running statistics in
    one all-reduce, then the SGD step, the same on every rank. Returns
    `train_step(state, images, labels) -> (state, loss)` with the mean
    loss. An explicit all-reduce, not DistributedDataParallel: DDP would
    average synced ABN's weight and bias gradients, which are the group's
    sums here, as in the JAX package (its `psum`, then `pmean`)."""
    group = mesh["dp"]
    params = [p for p in model.parameters() if p.requires_grad]
    stats = [b for b in model.buffers() if b.is_floating_point()]

    def train_step(state: TrainState, images, labels):
        loss = _loss_and_grads(model, cfg, state, images, labels)
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        mean_over([p.grad for p in params] + [loss] + stats, group)
        state.optimizer.step()
        state.step += 1
        return state, loss

    return train_step


def shard_batch(batch: Tuple[np.ndarray, np.ndarray], mesh: DeviceMesh):
    """This rank's rows of a global (images, labels) batch, split over `dp`."""
    return shard_leading_axis(tuple(batch), mesh, "dp")


# ---------------------------------------------------------------------------
# Checkpoints: the model with its buffers, the optimizer's momentum and the
# step, one file per saved step; restoring them is a true resume.
# ---------------------------------------------------------------------------

_CKPT = re.compile(r"step_(\d+)\.pt")


def _latest(ckpt_dir: Union[str, Path]) -> Optional[Path]:
    d = Path(ckpt_dir)
    found = [(int(m.group(1)), p) for p in d.glob("step_*.pt") if (m := _CKPT.fullmatch(p.name))]
    return max(found)[1] if found else None


def save_checkpoint(ckpt_dir: Union[str, Path], state: TrainState) -> Path:
    d = Path(ckpt_dir)
    d.mkdir(parents=True, exist_ok=True)
    path = d / f"step_{state.step:08d}.pt"
    tmp = path.with_suffix(f".tmp{os.getpid()}")
    torch.save({"model": state.model.state_dict(), "optimizer": state.optimizer.state_dict(),
                "step": state.step}, tmp)
    os.replace(tmp, path)
    return path


def restore_checkpoint(ckpt_dir: Union[str, Path], state: TrainState) -> TrainState:
    """The state with the latest checkpoint in `ckpt_dir` loaded into it in
    place, or the state unchanged when there is none."""
    path = _latest(ckpt_dir) if Path(ckpt_dir).is_dir() else None
    if path is None:
        return state
    device = next(state.model.parameters()).device
    saved = torch.load(path, map_location=device, weights_only=True)
    state.model.load_state_dict(saved["model"])
    state.optimizer.load_state_dict(saved["optimizer"])
    state.step = int(saved["step"])
    return state


def train_loop(cfg: TrainConfig, data_iter, ckpt_dir: Optional[str] = None,
               num_steps: Optional[int] = None, seed: int = 0, log_every: int = 50,
               logger=None, device: Optional[Union[str, torch.device]] = None,
               mesh: Optional[DeviceMesh] = None):
    """Train until `num_steps` (default `cfg.max_iter`) steps are taken,
    resuming from `ckpt_dir`'s latest checkpoint and saving there every
    `cfg.ckpt_every` steps and at the end (the first rank writes). Returns
    (model, state, losses), the losses of the steps this call took as
    floats. The loop does not wait for the device between steps except to
    log.

    With a `mesh` (a `dp` axis), or whenever a process group is up (then a
    1-D `dp` mesh over the whole world), every step is
    `make_sharded_train_step`'s: `data_iter` yields the global batch, of
    which each rank takes its rows, and `norm="abn_sync"` syncs the norms
    over `dp`. Without either it is the single-device step."""
    if mesh is None and dist.is_initialized():
        mesh = make_mesh(axis_names=("dp",))
    axis = mesh["dp"] if mesh is not None and cfg.norm == "abn_sync" else None
    model, state = create_train_state(cfg, seed, device, axis_name=axis)
    if ckpt_dir is not None:
        state = restore_checkpoint(ckpt_dir, state)
    if mesh is None:
        step_fn = make_train_step(model, cfg)
    else:
        sharded = make_sharded_train_step(model, cfg, mesh)

        def step_fn(state, images, labels):
            return sharded(state, *shard_batch((images, labels), mesh))
    target = num_steps if num_steps is not None else cfg.max_iter
    losses = []
    while state.step < target:
        images, labels = next(data_iter)
        state, loss = step_fn(state, images, labels)
        losses.append(loss)
        if logger and state.step % log_every == 0:
            logger.info("it %d loss %.4f", state.step, float(loss))
        if ckpt_dir is not None and state.step % cfg.ckpt_every == 0 and is_first_rank():
            save_checkpoint(ckpt_dir, state)
    if ckpt_dir is not None and is_first_rank():
        save_checkpoint(ckpt_dir, state)
    return model, state, torch.stack(losses).tolist() if losses else []
