"""Multimodal stack (counterpart of ``llm_quest_tpu/multimodal``): the
ViT→GPT-2 VLM and on-device image preprocessing."""
