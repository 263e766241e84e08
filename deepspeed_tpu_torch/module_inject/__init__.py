"""Module injection: HF -> deepspeed_tpu_torch conversion and AutoTP, the
JAX package's ``module_inject/`` (reference deepspeed/module_inject/:
replace_module.py, policy.py, auto_tp.py)."""

from .policy import (replace_transformer_layer, register_policy,  # noqa: F401
                     policy_for)
from .auto_tp import auto_tp_rules  # noqa: F401
