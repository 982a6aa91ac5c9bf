from .bcpnn_models import (BCPNN_MODELS, MODEL1_MNIST, MODEL2_PNEUMONIA,
                           MODEL3_BREAST, deep_mnist_spec, deep_synth_spec)

__all__ = ["BCPNN_MODELS", "MODEL1_MNIST", "MODEL2_PNEUMONIA",
           "MODEL3_BREAST", "deep_mnist_spec", "deep_synth_spec"]
