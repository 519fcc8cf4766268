"""PyTorch + CUDA port of ``llm_quest_tpu`` for NVIDIA Hopper (H100).

The JAX package ``llm_quest_tpu`` is the reference: every module here has its
counterpart at the same relative path there, with the same function names,
and the tests hold the two to each other on the CPU. This package imports
torch and numpy only — never jax and never ``llm_quest_tpu``.

Slices ported so far: Qwen3.5-0.8B multimodal generation
(``models/qwen3_5.py::generate_multimodal``) with the batched text decode
engine (``inference/generate.py``), the dense Qwen3 training step
(``models/qwen3.py``, ``training/engine.py``), the Qwen3-Next hybrid MoE
training step (``models/qwen3_next.py``, ``ops/moe.py``), the int8 serving
path (``ops/quantization.py``, the int8 KV cache), the Gemma-3
sliding-window training step (``models/gemma3.py``), the ViT encode and its
training (``models/vit.py``, ``training/vit_engine.py``), the MiMo-V2-Flash
and DeepSeek-V3 MTP training steps, context-parallel training of the dense
Qwen3 (``parallel/``), the int8-score ablation (``scripts/``), the
continuous-batching engine with its admissions, multi-LoRA and speculative
windows (``inference/``), GPT-2, Llama-3.2 (with the YaRN RoPE tables)
and Hyper-Qwen3 (``ops/hyper_connections.py``), and the fine-tuning and
alignment stack over GPT-2 (``training/classifier.py``, checkpoints and
profiling, ``alignment/``: DPO, the reward model, GRPO, RLVR, RPT). Every TPU
kernel of the JAX package is rewritten as CUDA C++ for ``sm_90a``
(``csrc/``, bound in ``kernels/``), flash attention (with its sliding
window, softcap and sinks) and the GDN prefill with their backward.
"""
