from .denoise import (  # noqa: F401
    CfgEpsClosure,
    CfgEpsFeatClosure,
    DecodeClosure,
    EncodeClosure,
    EpsClosure,
    EpsFeatClosure,
    Trajectory,
    generate,
)
from .edit import EditResult, edit_split  # noqa: F401
from .invert import (  # noqa: F401
    InversionResult,
    ddim_invert,
    ddpm_invert,
    ddpm_invert_batched,
    ddpm_sample,
    sample_xts,
)
