"""Seeded synthetic data streams (host numpy), checkpointable."""
from .pipeline import DataState, ImageStream, TokenStream

__all__ = ["DataState", "ImageStream", "TokenStream"]
