"""The card probes under ``tools/`` on the CPU: each imports (a broken import
shows here, not on the card), is built on the one shared harness
(``tools/probe_harness.py``), and every source edit of its variants still
applies to the kernel source it edits."""

import importlib
from pathlib import Path

import pytest

from tools import probe_harness as ph

PROBES = ["gdn_probe", "int8_attention_probe", "qgmm_probe", "short_attention_probe", "k10_k12_probe",
          "gdn_step_probe"]


@pytest.mark.parametrize("name", PROBES)
def test_probe_imports_on_the_harness(name):
    mod = importlib.import_module(f"tools.{name}")
    assert callable(mod.main)
    assert Path(mod.ph.__file__).resolve() == Path(ph.__file__).resolve()  # the shared harness, not a copy


def edits_of(name):
    """[(source, edits)] of a probe's variants."""
    mod = importlib.import_module(f"tools.{name}")
    if name == "int8_attention_probe":
        return [(mod.TC_SRC, edits) for edits in mod.VARIANTS.values()]
    if name == "short_attention_probe":
        return [(mod.KERNEL_SRC.name, edits) for edits in mod.VARIANTS.values()]
    if name == "gdn_step_probe":
        return [(mod.SRC, edits) for edits in mod.VARIANTS.values() if edits]
    return [(mod.TARGETS[part], edits) for part, edits in mod.VARIANTS.values() if edits]


@pytest.mark.parametrize("name", ["int8_attention_probe", "short_attention_probe", "k10_k12_probe",
                                  "gdn_step_probe"])
def test_variant_edits_apply(name):
    for src, edits in edits_of(name):
        text = (ph.CSRC / src).read_text()
        assert ph.apply_edits(text, edits, name) != text


def test_turns_and_stale_edits():
    assert ph.in_turns(["a", "b"]) == ["a", "b", "b", "a"] and ph.in_turns(["a"]) == ["a"]
    with pytest.raises(RuntimeError, match="not in the source"):
        ph.apply_edits("x = 1", [("y", "z")], "probe")
    assert ph.kernel_name("void llmq::(anonymous namespace)::flash_decode_tc_kernel<256>(args)") == \
        "flash_decode_tc_kernel"


def test_smoke_phases_takes_only_records_and_phases_of_chip_smoke():
    """``tools/smoke_phases.py`` refuses a name that is neither a kernel record
    nor a phase of ``chip_smoke.py`` before it builds anything, and needs the
    card for the others."""
    from tools import smoke_phases

    with pytest.raises(SystemExit, match="bogus"):
        smoke_phases.main(["gpt2_train", "bogus"])
    with pytest.raises(SystemExit, match="none given"):
        smoke_phases.main([])
    with pytest.raises(SystemExit, match="no CUDA device"):
        smoke_phases.main(["flash_attention_fwd_gpt2", "engine_llama"])
