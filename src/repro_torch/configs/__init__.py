from .base import SHAPES, ModelConfig, ShapeConfig
from .archs import ARCHS, get_config, smoke
from .bcpnn_models import (BCPNN_MODELS, MODEL1_MNIST, MODEL2_PNEUMONIA,
                           MODEL3_BREAST, deep_mnist_spec, deep_synth_spec)

__all__ = ["SHAPES", "ModelConfig", "ShapeConfig", "ARCHS", "get_config",
           "smoke", "BCPNN_MODELS", "MODEL1_MNIST", "MODEL2_PNEUMONIA",
           "MODEL3_BREAST", "deep_mnist_spec", "deep_synth_spec"]
