"""Host-side helpers with no device work: the CLIP tokenizer and the PIL
image codecs (PIL imported only when a codec is called)."""

from .tokenizer import CLIPTokenizer  # noqa: F401
