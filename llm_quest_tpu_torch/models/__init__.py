"""Model families (counterpart of ``llm_quest_tpu/models``): Qwen3.5, dense Qwen3, Qwen3-Next and Gemma-3 so far."""
