"""Plotting and display helpers, host-side: the port's own copy of the JAX
package's `host/plotting.py`. Side-by-side strips with a source image,
labelled grids (e.g. one loss scale a row) and sample display. PIL and
matplotlib are imported when a helper is called, not with the module."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .transforms import tensor_to_pil


def concat_images(images: Sequence, axis: int = 0):
    """Horizontal (axis=0) or vertical (axis=1) strip of PIL images."""
    from PIL import Image

    arrs = [np.asarray(im.convert("RGB")) for im in images]
    h = min(a.shape[0] for a in arrs)
    w = min(a.shape[1] for a in arrs)
    arrs = [a[:h, :w] for a in arrs]
    return Image.fromarray(np.concatenate(arrs, axis=1 - axis))


def add_source_image(source, images: Sequence):
    """Prepend the source image to an edited strip."""
    return concat_images([source, *images])


def show_images_in_a_grid(
    images: Sequence,
    num_cols: int = 4,
    row_labels: Optional[Sequence[str]] = None,
    figsize_per_cell: float = 2.5,
    title: Optional[str] = None,
):
    """Grid of PIL images with optional per-row labels, e.g. loss scales.
    Returns the matplotlib figure (the Agg backend unless one is set)."""
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    n = len(images)
    rows = (n + num_cols - 1) // num_cols
    fig, axes = plt.subplots(
        rows, num_cols, figsize=(figsize_per_cell * num_cols, figsize_per_cell * rows)
    )
    axes = np.atleast_2d(axes)
    for i in range(rows * num_cols):
        ax = axes[i // num_cols, i % num_cols]
        ax.axis("off")
        if i < n:
            ax.imshow(np.asarray(images[i].convert("RGB")))
            if row_labels is not None and i % num_cols == 0:
                ax.set_title(row_labels[i // num_cols], fontsize=9)
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    return fig


def display_samples(samples, num_cols: int = 4, **kwargs):
    """PIL images, or (C, H, W) / (1, C, H, W) tensors in [-1, 1] (a (B, C,
    H, W) batch iterates as such), -> grid."""
    from PIL import Image

    pils = [s if isinstance(s, Image.Image) else tensor_to_pil(s) for s in samples]
    return show_images_in_a_grid(pils, num_cols=num_cols, **kwargs)
