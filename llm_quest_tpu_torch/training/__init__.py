"""Training engine and FLOP accounting (counterpart of ``llm_quest_tpu/training``)."""
