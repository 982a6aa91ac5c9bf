"""BCPNN core — the port's counterpart of ``repro.core`` for the names
ported so far (dense, patchy and compact layouts, single device; the
epoch programs as captured steps on the card, ``graphs.py``; the head on
an LM trunk, ``head.py``)."""
from .hypercolumns import LayerGeom, encode_scalar_hcs, hc_hardmax, hc_softmax
from .traces import (Traces, init_traces, mutual_information, update_traces,
                     weights_from_traces)
from .bcpnn_layer import (
    BACKENDS, InferPack, Projection, ProjSpec, forward, init_projection,
    is_compact, is_patchy, learn, learn_masked, maybe_rewire, normalize,
    rewire, support, topk_mask, validate_patchy_mask, validate_patchy_state,
)
from .compact import (build_table, cached_table, compact_network_spec,
                      compactify_projection, compactify_state,
                      densify_pij, densify_projection, rewire_compact)
from .network import (
    BCPNNConfig,
    DeepState,
    NetworkSpec,
    as_spec,
    hidden_rates,
    infer,
    init_deep,
    init_network,
    make_network_spec,
    online_learn_step,
    spec_from_dict,
    spec_to_dict,
    stack_rates,
    supervised_readout_step,
    supervised_step,
    train_projection_step,
    unsupervised_layer_step,
    unsupervised_step,
)
from .head import (BCPNNHeadConfig, encode_features, head_predict,
                   head_supervised, head_unsupervised, init_head)
from .trainer import (Trainer, eval_batches, evaluate_padded,
                      supervised_epoch, unsupervised_epoch,
                      unsupervised_layer_epoch)

__all__ = [
    "LayerGeom", "encode_scalar_hcs", "hc_hardmax", "hc_softmax",
    "Traces", "init_traces", "mutual_information", "update_traces",
    "weights_from_traces",
    "BACKENDS", "InferPack", "Projection", "ProjSpec", "forward",
    "init_projection", "is_compact", "is_patchy", "learn", "learn_masked",
    "maybe_rewire", "normalize", "rewire", "support", "topk_mask",
    "validate_patchy_mask", "validate_patchy_state",
    "build_table", "cached_table", "compact_network_spec",
    "compactify_projection", "compactify_state", "densify_pij",
    "densify_projection", "rewire_compact",
    "BCPNNConfig", "DeepState", "NetworkSpec", "as_spec", "hidden_rates",
    "infer", "init_deep", "init_network", "make_network_spec",
    "online_learn_step", "spec_from_dict", "spec_to_dict", "stack_rates",
    "supervised_readout_step", "supervised_step", "train_projection_step",
    "unsupervised_layer_step", "unsupervised_step",
    "BCPNNHeadConfig", "encode_features", "head_predict", "head_supervised",
    "head_unsupervised", "init_head",
    "Trainer", "eval_batches", "evaluate_padded", "supervised_epoch",
    "unsupervised_epoch", "unsupervised_layer_epoch",
]
