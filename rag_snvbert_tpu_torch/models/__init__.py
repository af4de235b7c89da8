"""Model zoo: embeddings, fusion, transformer encoder, heads (torch)."""

from .bert import BERT, BERTWithEmbeddingRAG
from .heads import (BERTFoundationModel, EnhancedHaplotypeClassifier,
                    GenotypeClassifier)
from .layers import init_weights

__all__ = ["BERT", "BERTWithEmbeddingRAG", "BERTFoundationModel",
           "EnhancedHaplotypeClassifier", "GenotypeClassifier",
           "init_weights"]
