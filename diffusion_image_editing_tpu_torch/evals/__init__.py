"""Evaluation: LPIPS and the PSNR and anyGAN attribute metrics (the port of
the JAX package's `evals/`)."""

from ..models.port import port_vgg16_lpips  # noqa: F401
from .lpips import LPIPS, VGG16Features, make_lpips_fn  # noqa: F401
from .metrics import (  # noqa: F401
    attribute_consistency,
    avg_increase_decrease_per_attribute,
    inversion_roundtrip_metrics,
    mse,
    predict_attributes,
    psnr,
    run_attribute_evaluation,
)
