"""Model zoo: embeddings, fusion, transformer encoder, heads (torch)."""

from .bert import BERT, BERTWithEmbeddingRAG, BERTWithRAG
from .fusion import (ConcatFusion, CrossAttentionFusion, FixedConcatFusion,
                     RareVariantAwareFusion)
from .heads import (BERTFoundationModel, EnhancedHaplotypeClassifier,
                    GenotypeClassifier)
from .layers import init_weights

__all__ = ["BERT", "BERTWithEmbeddingRAG", "BERTWithRAG",
           "BERTFoundationModel", "ConcatFusion", "CrossAttentionFusion",
           "FixedConcatFusion", "RareVariantAwareFusion",
           "EnhancedHaplotypeClassifier", "GenotypeClassifier",
           "init_weights"]
