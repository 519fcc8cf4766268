"""Model families (counterpart of ``llm_quest_tpu/models``): Qwen3.5, dense Qwen3 and Qwen3-Next so far."""
