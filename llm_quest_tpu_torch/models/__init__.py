"""Model families (counterpart of ``llm_quest_tpu/models``): Qwen3.5 and dense Qwen3 so far."""
