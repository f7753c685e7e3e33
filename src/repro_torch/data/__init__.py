from .pipeline import DataConfig, Prefetcher, SyntheticStream

__all__ = ["DataConfig", "Prefetcher", "SyntheticStream"]
