"""The parts of ``chip_smoke.py`` that run on the CPU: its phase
selector, and the LM checks of phases 9 and 11 at smoke size, with the
CPU standing in for the card (each check then compares the CPU with
itself, so its errors are 0 and what is held is the walk's structure).

- ``lm_stages``' walk is ``LM.forward`` bit for bit for every arch (an
  encoder layer by layer, a VLM's patch prefix, a hybrid's pattern
  slots and tail), ``lm_stage_pass`` on the walk's own inputs gives the
  walk's outputs and the grads of a pass that walks on its own, all
  finite;
- ``lm_init`` is ``LM.init`` for an uncut config and keeps the
  published stack's scale for a cut one; phase 9(b) cuts
  granite-4.0-h-small to its portbench share, and A1's timed shape of it
  takes the config's softmax scale;
- ``teacher_forced`` runs an MoE model's prefill on the forward's own
  layer inputs too, so that the capacity the prompt alone would give
  does not change the next layer's cache: granite at its published 1/4
  expert ratio and capacity factor decodes every kept token exactly;
- ``prefill``'s own logits are the forward's over the prompt alone, bit
  for bit, for every arch (the reading phase 11 holds at full width);
- ``LmCpuSide`` runs the CPU sides in a thread, parks it between
  stages and stops it.
"""
import dataclasses
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402
from repro_torch.configs import (ARCHS, PORT_ARCHS, get_config,  # noqa: E402
                                 get_smoke_config)
from repro_torch.models.transformer import LM  # noqa: E402

CPU = torch.device("cpu")


@pytest.mark.parametrize("argv,want", [
    ([], None), (["--phases", "9,11"], ("9", "11")),
    (["--phases", "13,8"], ("8", "13")), (["--phases", "10"], ("10",))])
def test_phase_selector_reads_names(argv, want):
    assert chip_smoke.parse_phases(argv) == want


@pytest.mark.parametrize("argv", [
    ["--phases", "7"], ["--phases", "9,x"], ["--phases", ""], ["--phase",
                                                             "9"],
    ["--phases"], ["9"]])
def test_phase_selector_refuses_other_names(argv):
    with pytest.raises(ValueError):
        chip_smoke.parse_phases(argv)
    assert chip_smoke.main(argv) == 1     # before it looks for a card


@pytest.mark.parametrize("arch", ARCHS + PORT_ARCHS)
def test_stage_walk_is_the_forward(arch):
    cfg = dataclasses.replace(get_smoke_config(arch),
                              compute_dtype="float32")
    lm = LM(cfg, device=CPU)
    lm.init(torch.Generator().manual_seed(3))
    batch = chip_smoke.lm_batch(cfg, 2, 16, CPU, 4)
    walk = chip_smoke.lm_hidden(lm, batch)
    with torch.no_grad():
        logits, _ = lm(batch["tokens"], {
            k: v for k, v in batch.items()
            if k in ("patch_embeds", "frames")})
    assert torch.equal(walk[-1], logits.float())
    names = [s[0] for s in chip_smoke.lm_stages(lm, lm.param_tree(), batch)]
    assert len(names) == len(walk) and names[-1] == "head"
    if cfg.family == "encdec":
        assert names[:cfg.n_enc_layers + 2] == [
            f"enc{i}" for i in range(cfg.n_enc_layers)] + ["enc_norm",
                                                           "embed"]
    assert names.count("embed") == 1
    assert len(names) - names.index("embed") - 2 == cfg.n_layers
    passed = list(chip_smoke.lm_stage_pass(lm, batch, walk, seed=9))
    assert len(passed) == len(walk)
    for (y, grads), w in zip(passed, walk):     # each stage on the walk's
        assert torch.equal(y, w)                # own input: its output
        assert grads and all(torch.isfinite(t).all() for t in grads.values())
    own = list(chip_smoke.lm_stage_pass(lm, batch, None, seed=9))
    for (y, g), (z, h) in zip(own, passed):     # a walk of its own
        assert torch.equal(y, z) and g.keys() == h.keys()
        assert all(torch.equal(g[k], h[k]) for k in g)


def test_teacher_forced_moe_at_published_capacity():
    """granite's smoke config at top-8 of 32 experts, B = 4, 12 + 6:
    the forward over 72 tokens drops assignments at capacity that the
    prompt's 48 would not, so only a prefill run on the forward's own
    layer inputs leaves each layer's cache as the forward's. Every kept
    token's decode output is then the forward's exactly (one device,
    float32), the dropped ones are counted, and no routing differs."""
    cfg = dataclasses.replace(get_smoke_config("granite_moe_1b_a400m"),
                              n_experts=32, top_k=8,
                              compute_dtype="float32")
    lm = LM(cfg, device=CPU)
    params = lm.init(torch.Generator().manual_seed(140))
    tokens = chip_smoke.lm_batch(cfg, 4, 18, CPU, 141)["tokens"]
    seen, logits, routed = chip_smoke.forward_walk(lm, tokens, 12, {})
    assert len(seen) == cfg.n_layers and all(r is not None for r in routed)
    got = chip_smoke.teacher_forced(lm, params, tokens, 12, {}, seen,
                                    logits, routed)
    assert got["layer_errs"] == [0.0] * cfg.n_layers
    assert got["head_err"] == 0.0
    assert got["route_flips"] == []
    assert 0 < got["dropped"] < got["dropped_of"] == 4 * 6 * cfg.n_layers


@pytest.mark.parametrize("arch", ARCHS + PORT_ARCHS)
def test_lm_init_uncut_is_the_references_rule(arch):
    """``chip_smoke.lm_init`` of an uncut config is ``LM.init`` bit for
    bit (the reference's rule, one generator, sorted paths)."""
    cfg = get_smoke_config(arch)
    a, b = LM(cfg, device=CPU), LM(cfg, device=CPU)
    a.init(torch.Generator().manual_seed(5))
    chip_smoke.lm_init(b, cfg, torch.Generator().manual_seed(5))
    for (name, x), (_, y) in zip(sorted(a.named_parameters()),
                                 sorted(b.named_parameters())):
        assert torch.equal(x, y), name


def test_lm_init_cut_keeps_the_published_scale():
    """Cut from 2 layers to 1, llava's smoke stack is drawn at the
    published stack's 1/sqrt(2), not the cut one's 1/sqrt(1); leaves
    outside the stack keep their own scale."""
    full = get_smoke_config("llava_next_34b")
    cut = dataclasses.replace(full, n_layers=1)
    lm = LM(cut, device=CPU)
    params = dict(chip_smoke.lm_init(lm, full, torch.Generator()
                                     .manual_seed(6)).items())
    wi = params["blocks"]["mlp"]["wi"].detach()
    assert abs(float(wi.std()) - 2 ** -0.5) < 0.03
    tok = params["embed"]["tok"].detach()   # drawn at its own scale, 1
    assert abs(float(tok.std()) - 1.0) < 0.03


def _cpu_job(arch, seed):
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    lm = LM(cfg, device=CPU)
    lm.init(torch.Generator().manual_seed(seed))
    return lm, chip_smoke.lm_batch(cfg, 1, 16, CPU, seed)


def test_cpu_side_thread_gives_each_job_its_own_result():
    """``LmCpuSide`` runs the jobs in a thread in the order they are put
    and gives each arch the CPU side ``lm_cpu_side`` gives when called
    directly, with its LM; a job that raises re-raises in ``result``;
    ``close`` ends the thread."""
    side = chip_smoke.LmCpuSide()
    try:
        jobs = {"whisper_medium": _cpu_job("whisper_medium", 1),
                "recurrentgemma_2b": _cpu_job("recurrentgemma_2b", 2)}
        for arch, (lm, batch) in jobs.items():
            side.put(arch, lm, batch)
        lm, batch = _cpu_job("stablelm_1_6b", 3)
        side.put("broken", lm, {"tokens": batch["tokens"]})   # no labels
        for arch, (lm, batch) in jobs.items():
            got = side.result(arch)
            assert got["lm"] is lm and side.host_lms.get(arch) is None
            want = chip_smoke.lm_cpu_side(lm, batch)
            assert len(got["walk"]) == len(want["walk"])
            for a, b in zip(got["walk"], want["walk"]):
                assert torch.equal(a, b)
            for g, h in zip(got["grads"], want["grads"]):
                assert g.keys() == h.keys()
                assert all(torch.equal(g[k], h[k]) for k in g)
        with pytest.raises(KeyError):
            side.result("broken")
    finally:
        side.close()
    assert not side.thread.is_alive()


def test_cpu_side_stop_ends_a_job_between_stages(monkeypatch):
    """The stop ``close`` sets ends a running job after the stage in
    hand: its ``result`` raises InterruptedError, and the thread ends."""
    lm, batch = _cpu_job("whisper_medium", 4)
    side = chip_smoke.LmCpuSide()
    real = chip_smoke.lm_stage_pass

    def stopping(*a, **k):                # the stop comes after stage 1
        for i, out in enumerate(real(*a, **k)):
            if i == 1:
                side.stop.set()
            yield out
    monkeypatch.setattr(chip_smoke, "lm_stage_pass", stopping)
    try:
        side.put("whisper_medium", lm, batch)
        with pytest.raises(InterruptedError):
            side.result("whisper_medium")
    finally:
        side.close()
    assert not side.thread.is_alive()


def test_cpu_side_parks_between_stages_and_resumes():
    """Paused, the thread parks before its next stage and ``parked``
    returns: the job does not run on until ``resume``; then it gives
    the CPU side of a run with no pause, its parked seconds apart.
    ``parked`` also returns when the thread has no job."""
    side = chip_smoke.LmCpuSide()
    try:
        assert side.parked() < 5.0                   # no job: idle
        lm, batch = _cpu_job("recurrentgemma_2b", 5)
        side.pause()
        side.put("recurrentgemma_2b", lm, batch)
        side.parked()
        assert not side.done["recurrentgemma_2b"].wait(0.3)
        side.resume()
        got = side.result("recurrentgemma_2b")
        assert got["held_s"] >= 0.3
        want = chip_smoke.lm_cpu_side(lm, batch)
        assert want["held_s"] == 0.0
        for a, b in zip(got["walk"], want["walk"]):
            assert torch.equal(a, b)
    finally:
        side.close()
    assert not side.thread.is_alive()


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_is_the_forward_over_the_prompt(arch):
    """``forward_readings``' held reading: ``prefill``'s logits are
    ``LM.forward``'s over the prompt alone bit for bit on one device,
    granite at its published 1/4 expert ratio too, where the forward
    over every position (another capacity) differs from both."""
    cfg = get_smoke_config(arch)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, n_experts=32, top_k=8)
    cfg = dataclasses.replace(cfg, compute_dtype="float32")
    lm = LM(cfg, device=CPU)
    params = lm.init(torch.Generator().manual_seed(140))
    batch = chip_smoke.lm_batch(cfg, 4, 18, CPU, 141)
    extras = {k: v for k, v in batch.items()
              if k in ("patch_embeds", "frames")}
    prompt = max(12, (cfg.n_patches or 0) + 1)
    with torch.no_grad():
        got = chip_smoke.free_running(lm, params, batch["tokens"], prompt,
                                      extras)
        full = lm(batch["tokens"], extras)[0][:, prompt - 1:].float()
    r = chip_smoke.forward_readings(lm, batch["tokens"], prompt, extras,
                                    got, full)
    assert r["prefill_vs_prompt_forward"] == 0.0
    if arch == "granite_moe_1b_a400m":
        assert r["step0"] > chip_smoke.SERVE_TOL


def test_phase_9_runs_every_config_once():
    """Phase 9(b)'s run order is its configs, each once."""
    assert sorted(chip_smoke.LM_ORDER) == sorted(chip_smoke.LM_FULL)
    assert len(set(chip_smoke.LM_ORDER)) == len(chip_smoke.LM_FULL)


def test_phase_9_cuts_granite_hybrid_to_its_share():
    """Phase 9(b) trains granite-4.0-h-small as its portbench cell does:
    the preset's one-device share (one period, 9 of 72 experts held),
    and its A1 shape is the config's attention at its softmax scale."""
    from repro_torch.configs.granite_4_0_h_small import SHARE
    full, cfg = chip_smoke.lm_full_config("granite_4_0_h_small")
    assert full == get_config("granite_4_0_h_small")
    assert cfg == dataclasses.replace(SHARE, name=full.name)
    assert chip_smoke.lm_full_config("stablelm_1_6b")[1] == \
        get_config("stablelm_1_6b")
    (row,) = [r for r in chip_smoke.A1_SHAPES if r[1] == "granite_4_0_h_small"]
    assert row[2:] == (2, 4096, full.n_heads, full.n_kv_heads, full.hd,
                       full.attention_multiplier)
    for _, arch, *_, scale in chip_smoke.A1_SHAPES:
        assert scale == get_config(arch).attention_multiplier


def test_a1_exact_takes_the_scale():
    """``a1_exact`` at a given scale is float64 causal softmax attention
    at that scale; None is hd^-0.5."""
    g = torch.Generator().manual_seed(8)
    q, k, v, dout = (torch.randn((1, 6, n, 4), generator=g).to(
        torch.bfloat16) for n in (2, 1, 1, 2))
    for scale, want_scale in ((None, 0.5), (1 / 128, 1 / 128)):
        out = chip_smoke.a1_exact(q, k, v, dout, scale)[0]
        kk, vv = (t.double().repeat_interleave(2, dim=2) for t in (k, v))
        sc = torch.einsum("bqhd,bkhd->bhqk", q.double(), kk) * want_scale
        sc = sc.masked_fill(~torch.ones((6, 6), dtype=torch.bool).tril(),
                            float("-inf"))
        want = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(sc, -1), vv)
        torch.testing.assert_close(out, want, rtol=1e-12, atol=1e-12)
