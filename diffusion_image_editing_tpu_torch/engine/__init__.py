from .denoise import CfgEpsClosure, DecodeClosure, EncodeClosure, EpsClosure  # noqa: F401
from .edit import EditResult, edit_split  # noqa: F401
from .invert import InversionResult, ddpm_invert, ddpm_invert_batched, sample_xts  # noqa: F401
