"""Alignment stack: DPO/cDPO, the reward model, the GRPO family, RLVR and RPT (counterpart of ``llm_quest_tpu/alignment``)."""
