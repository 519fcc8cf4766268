"""Speculative decoding benchmark entry script (counterpart of
``scripts/spec_decoding_generate.py``): GPT-2 355M ("gpt_m") as the target
and GPT-2 124M ("gpt_s") as the draft, seeded random weights in bf16, greedy;
for each max_gen the plain target-only ``generate_kv_cache`` and then
``speculative_generate`` at each γ, reporting tok/s, the speedup over plain
decoding and the windows run.

    python -m llm_quest_tpu_torch.scripts.spec_decoding_generate

Divergences from the JAX script, by design:
- each timed call follows one untimed call of the same shape (JAX's runs
  compile there) and ends in ``torch.cuda.synchronize``;
- ``main`` takes the sweep (``gammas``, ``max_gens``) and the device
  (None: the card, raising without one) and returns its readings;
- the speedup is the ratio of the two rates (JAX prints t_plain / t_spec ·
  n / max_gen, the same number).
"""

import time

import torch

from llm_quest_tpu_torch import config
from llm_quest_tpu_torch.config import resolve_device
from llm_quest_tpu_torch.inference import generate as gen
from llm_quest_tpu_torch.inference.spec_decoding import speculative_generate
from llm_quest_tpu_torch.models import gpt2

GAMMAS = (1, 2, 4, 8)
MAX_GENS = (50, 100)
TEMP = 0.0  # greedy (reference benchmark setting)
PROMPT = [[464, 2068, 7586, 21831, 18045, 625, 262]]  # "The quick brown fox jumps over the"
PAD_ID = 50256


def _timed(fn, device):
    fn()  # same shapes untimed first
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


def main(gammas=GAMMAS, max_gens=MAX_GENS, device=None, dtype=torch.bfloat16):
    """Run the sweep; returns {max_gen: {"plain_tok_s", "tokens", "gammas":
    {γ: {"tok_s", "speedup", "steps", "tokens", "equal_to_plain"}}}}."""
    device = resolve_device(device)
    target_cfg = dict(config.gpt2_config_creator("gpt_m"), dtype=dtype)
    draft_cfg = dict(config.gpt2_config_creator("gpt_s"), dtype=dtype)
    target = gpt2.init(target_cfg, generator=torch.Generator(device=device).manual_seed(0), device=device)
    draft = gpt2.init(draft_cfg, generator=torch.Generator(device=device).manual_seed(1), device=device)
    prompt = torch.tensor(PROMPT, device=device)
    results = {}
    with torch.inference_mode():
        for max_gen in max_gens:
            plain, t_plain = _timed(lambda: gen.generate_kv_cache(
                gpt2, target, target_cfg, prompt, max_gen=max_gen, temp=TEMP, eos_ids=-1, pad_id=PAD_ID,
            ), device)
            plain_rate = max_gen / t_plain
            plain_toks = plain["sequences"][0, prompt.shape[1]:].tolist()
            print(f"max_gen={max_gen}  plain: {plain_rate:.1f} tok/s", flush=True)
            row = {"plain_tok_s": plain_rate, "tokens": plain_toks, "gammas": {}}
            for gamma in gammas:
                out, t_spec = _timed(lambda gamma=gamma: speculative_generate(
                    gpt2, target, target_cfg, gpt2, draft, draft_cfg, prompt, max_gen=max_gen,
                    draft_max_gen=gamma, temp=TEMP, device=device,
                ), device)
                n = int(out["num_generated"])
                rate = n / t_spec
                toks = out["sequences"][0, prompt.shape[1]: prompt.shape[1] + n].tolist()
                row["gammas"][gamma] = {"tok_s": rate, "speedup": rate / plain_rate, "steps": int(out["num_steps"]),
                                        "tokens": toks, "equal_to_plain": toks == plain_toks[:n]}
                print(f"  gamma={gamma}: {rate:6.1f} tok/s  speedup {rate / plain_rate:.2f}x  "
                      f"steps={int(out['num_steps'])}", flush=True)
            results[max_gen] = row
    return results


if __name__ == "__main__":
    main()
