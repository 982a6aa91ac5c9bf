from .pipeline import Prefetcher, TokenStream, batch_indices
from .synthetic import Dataset, encode_images, load_or_synthesize, make_synthetic

__all__ = ["Dataset", "encode_images", "load_or_synthesize", "make_synthetic",
           "Prefetcher", "TokenStream", "batch_indices"]
