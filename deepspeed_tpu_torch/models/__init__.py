"""Models of the port."""

from .api import ModelSpec  # noqa: F401
from .gpt2 import (GPT2Config, GPT2Model, GPT2_125M, GPT2_350M,  # noqa: F401
                   GPT2_760M, GPT2_1_3B)
from .llama import (LlamaConfig, LlamaModel, LLAMA_7B, LLAMA_13B,  # noqa: F401
                    LLAMA2_70B)
from .bert import BertConfig, BertModel, BERT_BASE, BERT_LARGE  # noqa: F401
from .bloom import BloomConfig, BloomModel  # noqa: F401
from .gpt_neox import GPTNeoXConfig, GPTNeoXModel, gptj_config  # noqa: F401
from .opt import OPTConfig, OPTModel  # noqa: F401
from .gpt_neo import GPTNeoConfig, GPTNeoModel  # noqa: F401
