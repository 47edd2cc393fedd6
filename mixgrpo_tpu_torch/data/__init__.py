"""Data layer (mirrors mixgrpo_tpu/data/)."""

from mixgrpo_tpu_torch.data.dataset import EmbeddingCacheWriter, LatentDataset, PromptLoader

__all__ = ["EmbeddingCacheWriter", "LatentDataset", "PromptLoader"]
