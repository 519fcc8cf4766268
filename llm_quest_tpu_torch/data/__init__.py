"""Input pipeline (counterpart of ``llm_quest_tpu/data``)."""
