"""Logical sharding dims for every parameter leaf, by leaf name (mirrors
``repro/models/params.py``).

Convention-based: the leaf's last dict key determines its logical axes;
extra leading dimensions (the layer stacking of the JAX package's scan)
map to None.  Anything unknown is replicated.  A path is the JAX tree path
of the leaf, as a "/"-joined string (``"blocks/pos0_g/attn/wq"``) or a
sequence of keys; a leaf is anything with a ``shape`` in the JAX layout
(stacked repeats included).  ``param_shardings`` and ``cache_shardings``
give the port's ``NamedSharding`` of each leaf, keyed by path, or None
outside a sharding context.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple, Union

from ..distributed.sharding import NamedSharding, named_sharding

Path = Union[str, Sequence[str]]

# leaf name -> logical dims of the UNSTACKED parameter
LEAF_DIMS = {
    "tok_embed": ("vocab", "fsdp"),
    "pos_embed": (None, "fsdp"),
    "lm_head": ("fsdp", "vocab"),
    # attention / mlp projections
    "wq": ("fsdp", "tp"), "wk": ("fsdp", "tp"), "wv": ("fsdp", "tp"),
    "wi": ("fsdp", "tp"), "wg": ("fsdp", "tp"),
    # row-parallel weights: contraction dim on row_in, output on row_out
    "wo": ("row_in", "row_out"),
    "bq": ("tp",), "bk": ("tp",), "bv": ("tp",),
    "q_norm": (None,), "k_norm": (None,),
    # moe
    "router": ("fsdp", None),
    "wi_e": ("expert", "fsdp", None), "wg_e": ("expert", "fsdp", None),
    "wo_e": ("expert", None, "fsdp"),
    # mamba
    "in_proj": ("fsdp", "tp"), "out_proj": ("row_in", "row_out"),
    "conv_w": (None, "tp"), "conv_b": ("tp",),
    "x_proj": ("tp", None), "dt_w": (None, "tp"), "dt_bias": ("tp",),
    "A_log": ("tp", None), "D": ("tp",),
    # rg-lru
    "w_in": ("fsdp", "tp"), "w_gate": ("fsdp", "tp"),
    "w_out": ("row_in", "row_out"),
    "w_r": ("fsdp", "tp"), "w_i": ("fsdp", "tp"),
    "b_r": ("tp",), "b_i": ("tp",), "Lambda": ("tp",),
    # norms
    "scale": (None,), "bias": (None,),
}

# cache leaf name -> logical dims of the unstacked leaf
CACHE_DIMS = {
    "k": ("batch", "cache_seq", "kv_heads", "head_dim"),
    "v": ("batch", "cache_seq", "kv_heads", "head_dim"),
    "conv": ("batch", None, "tp"),
    "ssm": ("batch", "tp", None),
    "state": ("batch", "tp"),
    "enc_out": ("batch", None, "embed"),
    "pos": (),
}


def _keys(path: Path) -> Tuple[str, ...]:
    return tuple(path.split("/")) if isinstance(path, str) else tuple(path)


def _dims(table: Dict[str, Tuple], path: Path, leaf: Any) -> Tuple:
    ndim = len(leaf.shape)
    keys = _keys(path)
    dims = table.get(keys[-1] if keys else None)
    if dims is None:
        return tuple(None for _ in range(ndim))
    extra = ndim - len(dims)
    if extra < 0:  # scalar or reduced leaf
        return tuple(None for _ in range(ndim))
    return tuple([None] * extra) + tuple(dims)


def leaf_dims(path: Path, leaf: Any) -> Tuple:
    """Logical dims of a parameter leaf (its JAX-layout shape)."""
    return _dims(LEAF_DIMS, path, leaf)


def cache_dims(path: Path, leaf: Any) -> Tuple:
    """KV/recurrent cache leaves: batch-sharded, head/feature dims on TP."""
    return _dims(CACHE_DIMS, path, leaf)


def _leaves(tree) -> Dict[str, Any]:
    """``{path: leaf}`` of a flat dict of leaves, or of the port's ``LM``
    (its JAX-layout leaf specs)."""
    if isinstance(tree, dict):
        return tree
    from ..convert import lm_leaf_specs
    return lm_leaf_specs(tree)


def param_shardings(params) -> Dict[str, Optional[NamedSharding]]:
    """``{path: NamedSharding or None}`` of every parameter leaf of
    ``params`` (an ``LM``, or a flat dict of JAX-layout leaves)."""
    return {path: named_sharding(leaf_dims(path, leaf), leaf.shape)
            for path, leaf in _leaves(params).items()}


def cache_shardings(cache: Dict[str, Any]
                    ) -> Dict[str, Optional[NamedSharding]]:
    """``{path: NamedSharding or None}`` of a flat dict of JAX-layout
    cache leaves (``launch.steps.abstract_cache``)."""
    return {path: named_sharding(cache_dims(path, leaf), leaf.shape)
            for path, leaf in cache.items()}
