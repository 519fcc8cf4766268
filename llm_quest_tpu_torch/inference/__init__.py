"""Decode loop and KV cache (counterpart of ``llm_quest_tpu/inference``)."""
