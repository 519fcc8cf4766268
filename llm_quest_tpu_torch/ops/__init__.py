"""Functional building blocks on tensors (counterpart of ``llm_quest_tpu/ops``).

Boolean attention masks are True = MASKED (``masks.py``); (b, s) padding
masks are True = REAL token, as in the JAX package.
"""
