"""Weight loading (counterpart of ``llm_quest_tpu/weights``)."""
