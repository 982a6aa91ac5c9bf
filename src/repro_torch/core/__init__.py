"""BCPNN core — the port's counterpart of ``repro.core`` for the names
this slice ports (dense layout, single device)."""
from .hypercolumns import LayerGeom, encode_scalar_hcs, hc_hardmax, hc_softmax
from .traces import (Traces, init_traces, mutual_information, update_traces,
                     weights_from_traces)
from .bcpnn_layer import (
    BACKENDS, Projection, ProjSpec, forward, init_projection, learn,
    normalize, support, topk_mask,
)
from .network import (
    BCPNNConfig,
    DeepState,
    NetworkSpec,
    as_spec,
    infer,
    init_deep,
    make_network_spec,
    online_learn_step,
    spec_from_dict,
    spec_to_dict,
    stack_rates,
    supervised_readout_step,
    train_projection_step,
)
from .trainer import Trainer, evaluate_padded

__all__ = [
    "LayerGeom", "encode_scalar_hcs", "hc_hardmax", "hc_softmax",
    "Traces", "init_traces", "mutual_information", "update_traces",
    "weights_from_traces",
    "BACKENDS", "Projection", "ProjSpec", "forward", "init_projection",
    "learn", "normalize", "support", "topk_mask",
    "BCPNNConfig", "DeepState", "NetworkSpec", "as_spec", "infer",
    "init_deep", "make_network_spec", "online_learn_step", "spec_from_dict",
    "spec_to_dict", "stack_rates", "supervised_readout_step",
    "train_projection_step",
    "Trainer", "evaluate_padded",
]
