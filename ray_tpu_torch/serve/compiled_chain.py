"""Compiled serving chain (counterpart of `ray_tpu/serve/compiled_chain.py`).

Only the per-item error marker is ported so far: `LLMServer.batch_call`
returns it for an item that failed, as the chain's writer does.
"""

CHAIN_ERR = "__rtpu_chain_error__"
