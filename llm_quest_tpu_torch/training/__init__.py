"""Training engines (text models, MTP, ViT, classifiers), checkpoints, profiling and FLOP accounting (counterpart of ``llm_quest_tpu/training``)."""
