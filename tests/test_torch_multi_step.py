"""``train --steps-per-dispatch``: N train steps a dispatch.

On the CPU a chunk is the same N steps in a loop, so a chunked run's
losses are bitwise the per-step run's, its tail (shorter than N) runs
step by step, and checkpoints land at chunk boundaries whenever a chunk
crosses a ``--ckpt-every`` line (JAX tests/test_multi_step.py's case).
Across ranks (gloo CPU ranks here) the chunks are held against JAX
``make_multi_step`` at ``MeshSpec(dp=2)`` on ``tests/test_multi_step.py``'s
model and tokens (losses at rtol 1e-4 and parameters at atol 2e-4, rtol
1e-3: the port's train parity bounds, ``tests/test_torch_train.py``),
and ``cli train --dp 2`` chunked against its per-step run bitwise; on
the card they need the ``ipc`` transport. Chunks keep the
step count on the device on every device, so the CPU runs the card's
state. On the card (the ``cuda`` marker; skipped here) a chunk is one
CUDA graph replay, held bitwise against an eager run of the same step
code and counted as its captured launches times its replays, and the
chunks' state (capturable adamw) is held against the CPU's per-step
chain.
"""

import numpy as np
import pytest
import torch

from akka_allreduce_tpu_torch import cli
from akka_allreduce_tpu_torch.models import train as ttrain
from akka_allreduce_tpu_torch.models.transformer import TransformerConfig

BASE = ["train", "--device", "cpu", "--d-model", "16", "--n-layers", "1",
        "--d-ff", "32", "--vocab", "31", "--seq", "8", "--batch", "8",
        "--log-every", "100"]


def run(*flags):
    return cli.run_train(cli.build_parser().parse_args(BASE + list(flags)))


@pytest.mark.parametrize("spd,steps", [(2, 4), (4, 6)],
                         ids=["whole_chunks", "chunk_and_tail"])
def test_chunked_losses_are_the_per_step_runs(spd, steps):
    """Chunks of ``spd`` (and a tail of ``steps % spd`` run step by
    step) give the per-step run's losses bitwise, with an EMA kept."""
    flags = ["--steps", str(steps), "--ema-decay", "0.9",
             "--optimizer", "adafactor"]
    chunked = run(*flags, "--steps-per-dispatch", str(spd))
    plain = run(*flags)
    assert chunked["losses"] == plain["losses"]
    assert len(chunked["losses"]) == steps
    multi = chunked["multi_step"]
    assert multi["steps_per_dispatch"] == spd
    assert multi["graph_replays"] == 0  # the CPU runs no graph


def test_multi_step_tail_runs_step_by_step():
    cfg = ttrain.TrainConfig(model=TransformerConfig(
        vocab_size=31, d_model=16, n_heads=4, n_layers=1, d_ff=32,
        max_seq=8), learning_rate=1e-2)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, 31, size=(5, 2, 8), dtype=np.int32))
    states = [ttrain.make_train_state(
        cfg, generator=torch.Generator().manual_seed(0), device_step=ds)
        for ds in (True, True, False)]
    multi = ttrain.make_multi_step(cfg, 3)
    got = [multi(states[0], tokens[:3])["loss"],
           multi(states[0], tokens[3:])["loss"]]
    assert [g.shape[0] for g in got] == [3, 2] and states[0].step == 5
    step = ttrain.make_train_step(cfg)
    want = [float(step(states[1], tokens[i])["loss"]) for i in range(5)]
    assert torch.cat(got).tolist() == want and states[1].step == 5
    with pytest.raises(ValueError, match="steps per dispatch"):
        ttrain.make_multi_step(cfg, 0)
    # a chunk keeps its step count on the device, on every device
    with pytest.raises(ValueError, match="device_step=True"):
        multi(states[2], tokens[:3])


def _resume_matches_one_run(device, optimizer):
    """Four steps on a device-step state (the graph path's state) against
    two steps, a state dict round trip into a fresh state
    (``load_optimizer_state``) and two more: bitwise."""
    import copy
    cfg = ttrain.TrainConfig(model=TransformerConfig(
        vocab_size=97, d_model=128, n_heads=4, n_layers=1, d_ff=256,
        max_seq=32), learning_rate=1e-3, optimizer=optimizer,
        ema_decay=0.5, lr_schedule="cosine", warmup_steps=1, total_steps=4)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, 97, size=(4, 2, 32), dtype=np.int32)).to(device)

    def fresh():
        return ttrain.make_train_state(
            cfg, generator=torch.Generator(device).manual_seed(0),
            device_step=True)
    multi = ttrain.make_multi_step(cfg, 2)
    one = fresh()
    want = torch.cat([multi(one, tokens[:2])["loss"],
                      multi(one, tokens[2:])["loss"]])
    if device.type == "cuda":  # a captured chunk is bound to its state
        with pytest.raises(ValueError, match="state it was captured"):
            multi(fresh(), tokens[:2])
    first = fresh()
    got = [ttrain.make_multi_step(cfg, 2)(first, tokens[:2])["loss"]]
    saved = copy.deepcopy(first.optimizer.state_dict())
    again = fresh()
    with torch.no_grad():
        for live, kept in zip(
                ttrain.tree_leaves(again.params) +
                ttrain.tree_leaves(again.ema),
                ttrain.tree_leaves(first.params) +
                ttrain.tree_leaves(first.ema)):
            live.copy_(kept)
    again.step = first.step
    ttrain.load_optimizer_state(again, saved)
    assert int(again.count) == 2
    got.append(ttrain.make_multi_step(cfg, 2)(again, tokens[2:])["loss"])
    assert torch.equal(torch.cat(got), want)
    for a, b in zip(ttrain.tree_leaves(again.params),
                    ttrain.tree_leaves(one.params)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("optimizer", ["adamw", "lion", "adafactor", "sgd"])
def test_device_step_state_resumes_bitwise(optimizer):
    """On the CPU the device-step state (a shared rate tensor, a tensor
    step count) runs eagerly: a resume through the optimizer's state dict
    continues the run bitwise."""
    _resume_matches_one_run(torch.device("cpu"), optimizer)


def test_chunk_boundary_saves_and_resume(tmp_path, capsys):
    ckpt = ["--ckpt-dir", str(tmp_path), "--ckpt-every", "10",
            "--steps-per-dispatch", "4", "--ema-decay", "0.5"]
    # chunks [0-3] [4-7] [8-11]: only the third crosses a multiple of
    # 10, saving at its boundary step 11 (also the final step)
    run(*ckpt, "--steps", "12")
    steps = {int(p.name) for p in tmp_path.iterdir() if p.name.isdigit()}
    assert steps == {11}
    assert (tmp_path / "11" / "ema.pt").exists()
    capsys.readouterr()
    # resume: chunks [12-15] [16-19], tail [20-21] step by step; the
    # second chunk crosses 20 -> saves at 19; the final forced save at 21
    report = run(*ckpt, "--steps", "22")
    assert "resumed from step 11" in capsys.readouterr().out
    steps = {int(p.name) for p in tmp_path.iterdir() if p.name.isdigit()}
    assert {19, 21} <= steps
    assert report["config"]["start_step"] == 12
    assert len(report["losses"]) == 10


# tests/test_multi_step.py's model and tokens
JAX_MODEL = dict(vocab_size=61, d_model=32, n_heads=4, n_layers=1, d_ff=64,
                 max_seq=16)


def test_dp2_chunks_match_jax_make_multi_step():
    """JAX ``make_multi_step`` at ``MeshSpec(dp=2)`` (4 steps in one scan)
    against the port's chunks of 2 on two gloo ranks from the same
    weights and tokens, each rank on its half of every batch; the ranks
    end with equal parameters, and an eager step derives no rounding key
    on the f32 wire."""
    import jax
    import jax.numpy as jnp

    from akka_allreduce_tpu.models import train as jtrain
    from akka_allreduce_tpu.models.transformer import \
        TransformerConfig as JConfig
    from akka_allreduce_tpu.parallel.mesh import MeshSpec, make_device_mesh
    from akka_allreduce_tpu_torch.parallel.group import spawn_ranks
    from torch_multi_step_ranks import chunked_train
    k, b, t = 4, 4, 16
    tokens = np.random.default_rng(3).integers(
        0, JAX_MODEL["vocab_size"], size=(k, b, t), dtype=np.int32)
    mesh = make_device_mesh(MeshSpec(dp=2), devices=jax.devices()[:2])
    jcfg = jtrain.TrainConfig(model=JConfig(**JAX_MODEL), bucket_elems=256,
                              learning_rate=1e-2)
    params, opt_state, opt = jtrain.make_train_state(jax.random.key(1), jcfg,
                                                     mesh)
    init = jax.tree.map(np.asarray, params)
    p_chk, _, ms = jtrain.make_multi_step(jcfg, mesh, opt)(
        params, opt_state, jnp.asarray(tokens))
    ranks = spawn_ranks(chunked_train, 2, "gloo", "cpu", JAX_MODEL,
                        {"bucket_elems": 256, "learning_rate": 1e-2}, init,
                        tokens, 2)
    np.testing.assert_allclose(ranks[0]["losses"], np.asarray(ms["loss"]),
                               rtol=1e-4)
    want = [np.asarray(x) for x in jax.tree.leaves(p_chk)]
    for got, ref in zip(ranks[0]["params"], want):
        np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-3)
    assert all(np.array_equal(a, c) for a, c in zip(ranks[0]["params"],
                                                     ranks[1]["params"]))
    assert ranks[0]["keys"] == []


@pytest.mark.parametrize("wire,keys", [("int8", ["seed", "seed"]),
                                       ("ef8", ["bits"])])
def test_dp2_quantized_chunks_round_with_their_steps_keys(wire, keys):
    """On the int8 and ef8 wires the chunks of two gloo ranks (a chunk of
    3 and a tail of 1) give the per-step run's losses bitwise, and an
    eager step derives the keys a captured chunk gives slots to: two
    int8 seeds a sync (phase 1 and 2), one ef8 draw (phase 2)."""
    from akka_allreduce_tpu_torch.parallel.group import spawn_ranks
    from torch_multi_step_ranks import chunked_train
    from akka_allreduce_tpu_torch.models.transformer import init_transformer
    from akka_allreduce_tpu_torch import convert
    tokens = np.random.default_rng(5).integers(
        0, JAX_MODEL["vocab_size"], size=(4, 4, 16), dtype=np.int32)
    port = TransformerConfig(**JAX_MODEL)
    init = convert.params_to_jax(init_transformer(
        torch.Generator().manual_seed(2), port))
    kw = {"bucket_elems": 256, "learning_rate": 1e-2,
          "grad_transport": wire}
    chunked, plain = (spawn_ranks(chunked_train, 2, "gloo", "cpu", JAX_MODEL,
                                  kw, init, tokens, spd)
                      for spd in (3, 1))
    assert chunked[0]["losses"] == plain[0]["losses"]
    assert all(np.array_equal(a, c) for a, c in zip(chunked[1]["params"],
                                                     plain[1]["params"]))
    assert chunked[0]["keys"] == keys


@pytest.mark.parametrize("wire", ["f32", "ef8"])
def test_cli_dp2_chunks_equal_the_per_step_run(wire):
    """``cli train --device cpu --dp 2 --steps-per-dispatch 2`` (gloo
    ranks; on the CPU a chunk is its steps in a loop) gives the losses
    of ``--steps-per-dispatch 1`` bitwise over two chunks, and its ranks
    end equal. (Its state keeps the learning rate as a tensor, so the
    last update, which no loss reads, may round otherwise than the
    per-step run's float rate.)"""
    flags = ["--steps", "4", "--dp", "2", "--grad-quant",
             "none" if wire == "f32" else wire]
    chunked = run(*flags, "--steps-per-dispatch", "2")
    plain = run(*flags)
    assert chunked["losses"] == plain["losses"] and len(plain["losses"]) == 4
    assert chunked["multi_step"]["graph_replays"] == 0
    assert len({r["param_checksum"] for r in chunked["ranks"]}) == 1


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA graph has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("optimizer", ["adamw", "lion", "adafactor", "sgd"])
def test_graph_chunks_are_the_eager_steps_bitwise(cuda_device, optimizer):
    """Two replays of a captured 3-step chunk against the same step code
    run eagerly, step by step, on the same kind of state: losses, masters
    and EMA bitwise; the flash counters at the captured launches times
    the replays (plus the warm-up step)."""
    from akka_allreduce_tpu_torch.ops.kernels import flash_attention as fa
    cfg = ttrain.TrainConfig(model=TransformerConfig(
        vocab_size=97, d_model=128, n_heads=4, n_layers=2, d_ff=256,
        max_seq=64), learning_rate=1e-3, optimizer=optimizer,
        ema_decay=0.9, lr_schedule="cosine", warmup_steps=2, total_steps=4,
        clip_norm=1.0)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, 97, size=(6, 2, 64), dtype=np.int32)).to(cuda_device)

    def fresh():
        return ttrain.make_train_state(
            cfg, generator=torch.Generator(cuda_device).manual_seed(0),
            device_step=True)
    g_state, e_state = fresh(), fresh()
    g_multi = ttrain.make_multi_step(cfg, 3)
    before = fa.FLASH_FWD_LAUNCHES
    g_loss = torch.cat([g_multi(g_state, tokens[:3])["loss"],
                        g_multi(g_state, tokens[3:])["loss"]])
    torch.cuda.synchronize()
    g_fwd, before = fa.FLASH_FWD_LAUNCHES - before, fa.FLASH_FWD_LAUNCHES
    step = ttrain.make_train_step(cfg)
    e_loss = torch.stack([step(e_state, tokens[i])["loss"]
                          for i in range(6)])
    torch.cuda.synchronize()
    e_fwd = fa.FLASH_FWD_LAUNCHES - before
    assert torch.equal(g_loss, e_loss) and g_state.step == e_state.step == 6
    for a, b in zip(ttrain.tree_leaves(g_state.params) +
                    ttrain.tree_leaves(g_state.ema),
                    ttrain.tree_leaves(e_state.params) +
                    ttrain.tree_leaves(e_state.ema)):
        assert torch.equal(a, b)
    assert g_multi.replays == 2
    assert g_multi.captured_launches["flash_fwd"] == 2 * 3
    assert g_fwd == 2 * 3 * 2 + 2 and e_fwd == 2 * 6


@pytest.mark.cuda
@pytest.mark.parametrize("optimizer", ["adamw", "lion", "adafactor", "sgd"])
def test_device_step_on_the_card_is_the_cpu_chain(cuda_device, optimizer):
    """The chunks' state on the card (for adamw ``capturable=True``: its
    bias correction on the device) against the per-step state on the
    CPU, whose chain the CPU tests hold against optax: the same weights
    and gradients through six updates of a cosine schedule that warms
    up, decays and runs past its end, with clipping; every leaf within
    rtol 1e-6, atol 1e-7. Capturable adamw computes its bias corrections
    in f32 on the device (``1 - 0.999`` is 1.3e-5 off in f32, so its
    first update is ~6.4e-6 off relative): it is held within 1e-5 of the
    rate times the updates, far under the ``lr / 2`` that one wrong rate
    of the warmup moves an element by."""
    cfg = ttrain.TrainConfig(model=TransformerConfig(
        vocab_size=97, d_model=128, n_heads=4, n_layers=1, d_ff=256,
        max_seq=32), learning_rate=1e-2, optimizer=optimizer,
        ema_decay=0.5, lr_schedule="cosine", warmup_steps=2, total_steps=4,
        clip_norm=1.0)
    gen = torch.Generator().manual_seed(0)
    params = ttrain.init_transformer(gen, cfg.model, "cpu")
    grads = [[torch.randn(p.shape, generator=gen) * 0.3
              for p in ttrain.tree_leaves(params)] for _ in range(6)]
    finals = []
    for device, device_step in ((cuda_device, True), ("cpu", False)):
        state = ttrain.make_train_state(
            cfg, params=ttrain.tree_map(lambda p: p.detach().clone(),
                                        params),
            device=device, device_step=device_step)
        for g in grads:
            ttrain.apply_update(cfg, state, [x.to(device) for x in g])
        assert state.step == 6
        finals.append([t.detach().cpu() for t in
                       ttrain.tree_leaves(state.params)
                       + ttrain.tree_leaves(state.ema)])
    atol = (1e-5 * cfg.learning_rate * len(grads) if optimizer == "adamw"
            else 1e-7)
    for a, b in zip(*finals):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("optimizer", ["adamw", "lion"])
def test_graph_state_resumes_bitwise(cuda_device, optimizer):
    """The captured path's state resumed through ``load_optimizer_state``
    (adamw stays capturable, its step counts on the card) continues the
    run bitwise."""
    _resume_matches_one_run(cuda_device, optimizer)
