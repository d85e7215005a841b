from repro_torch.data.pipeline import TokenStream, make_stream

__all__ = ["TokenStream", "make_stream"]
