"""Model families (counterpart of ``llm_quest_tpu/models``): Qwen3.5, dense Qwen3, Qwen3-Next, Gemma-3, ViT, MiMo-V2-Flash and DeepSeek-V3 so far."""
