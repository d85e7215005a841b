from repro_torch.data.pipeline import EncDecStream, TokenStream, make_stream

__all__ = ["EncDecStream", "TokenStream", "make_stream"]
