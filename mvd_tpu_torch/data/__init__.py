from .tokenizer import CLIPBPETokenizer, HashTokenizer, load_tokenizer  # noqa: F401
