"""AutoTP: policy-free tensor-parallel partition rules, the JAX package's
``module_inject/auto_tp.py``.

From a parameter tree's leaf paths and shapes (a JAX-layout tree: numpy
arrays, tensors, anything with a ``shape``), in the JAX package's leaf
order (``elasticity.logical.leaf_paths``: dict keys sorted, as
``jax.tree.leaves`` flattens them):

- name heuristics first: qkv/fc/up/gate -> column-parallel (output dim
  over ``model``), proj/out/down/o_proj -> row-parallel (input dim over
  ``model``);
- unnamed 2D leaves alternate column/row in traversal order, which keeps
  matmul chains collective-free until the row-parallel reduce, the
  Megatron pairing AutoTP aims for.
"""

import re
from typing import List, Tuple

from ..elasticity.logical import leaf_paths
from ..parallel.topology import MODEL_AXIS

_COL = re.compile(r"(qkv|query|key|value|c_attn|fc|up_proj|gate_proj|wi|"
                  r"dense_h_to_4h)", re.I)
_ROW = re.compile(r"(proj\b|c_proj|out|o_proj|down_proj|wo|dense_4h_to_h|"
                  r"attn_proj|mlp_proj)", re.I)
# never TP-shard: norms, biases, embeddings-by-name (stacked [L, d] leaves
# look 2D but aren't matmuls)
_SKIP = re.compile(r"(ln|norm|bias|scale|emb|wte|wpe|pos)", re.I)


def auto_tp_rules(params_like, tp_size: int) -> List[Tuple[str, Tuple]]:
    """Emit (path_regex, spec) partition rules for a params tree."""
    if tp_size <= 1:
        return []
    rules = []
    next_is_col = True
    for path, shape in leaf_paths(params_like).items():
        if len(shape) < 2 or _SKIP.search(path):
            continue
        # the last two dims are the matmul dims (leading dims: layer stacks)
        d_in, d_out = shape[-2], shape[-1]
        named = _ROW.search(path) or _COL.search(path)
        if not named and min(d_in, d_out) < 32:
            continue  # stacked vector ([L, d]) masquerading as 2D
        col_ok = d_out % tp_size == 0
        row_ok = d_in % tp_size == 0
        if _ROW.search(path) and row_ok:
            spec = [None] * (len(shape) - 2) + [MODEL_AXIS, None]
            next_is_col = True
        elif _COL.search(path) and col_ok:
            spec = [None] * (len(shape) - 2) + [None, MODEL_AXIS]
            next_is_col = False
        elif col_ok and next_is_col:
            spec = [None] * (len(shape) - 2) + [None, MODEL_AXIS]
            next_is_col = False
        elif row_ok:
            spec = [None] * (len(shape) - 2) + [MODEL_AXIS, None]
            next_is_col = True
        else:
            continue
        rules.append((f"^{re.escape(path)}$", tuple(spec)))
    return rules
