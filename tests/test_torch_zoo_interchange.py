"""The port's interchange with the reference's ``torch.save`` checkpoints
against the JAX package's, on the CPU, at tests/test_zoo_import.py's tiny
widths.

- ``utils/zoo_import.py``: for all ten models the port's import of one
  reference state_dict equals JAX's import carried across
  (``utils/checkpoint.params_from_jax``) leaf for leaf, with the same
  ``missing``, and passes ``verify_shapes`` against the port's own init;
  a ``_TorchFilmGP`` state_dict (its conv1x1 layers set in the fixture)
  drives the port's film_gp_pt to the fixture's logits.
- ``utils/zoo_export.py``: the port's export of JAX's weights carried across
  is JAX's export key for key (in order) and byte for byte; export then
  import round-trips bit-exactly but for the conv1x1 leaves, which reference
  checkpoints never hold.
- ``utils/checkpoint.py load_any_checkpoint`` takes a ``.pt`` and an npz
  alike; the entry points take a ``.pt`` wherever JAX's do: ``q_only_test``
  (lstm) and ``q_and_v_test`` (mac) from one ``.pt`` give JAX's losses,
  hits, predictions and byte-equal dumps (the question-only LSTM's (h0, c0)
  zero on both sides: the two packages' generators cannot agree); the
  harness resumes from one at its epoch + 1 with a fresh Adam; the engine
  starts from one and hot-reloads another; ``cli/export_checkpoint`` writes
  JAX's CLI's state_dict; the released archive's layout plus a ``.pt`` runs
  through ``q_and_v_test`` and ``results_analysis``.
"""

import dataclasses
import functools
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videonavqa_tpu.cli import common as jcommon
from videonavqa_tpu.cli import export_checkpoint as jexport_cli
from videonavqa_tpu.cli import q_and_v_test as jq_and_v_test
from videonavqa_tpu.cli import q_only_test as jq_only_test
from videonavqa_tpu.data.synthetic import generate_synthetic_dataset
from videonavqa_tpu.models import get_model as jax_get_model
from videonavqa_tpu.models import q_only_lstm as jax_q_only_lstm
from videonavqa_tpu.utils import checkpoint as jckpt
from videonavqa_tpu.utils.checkpoint import flatten_tree
from videonavqa_tpu.utils.zoo_export import export_model_checkpoint as jax_export
from videonavqa_tpu.utils.zoo_import import import_model_checkpoint as jax_import
from videonavqa_tpu_torch.cli import common as tcommon
from videonavqa_tpu_torch.cli import export_checkpoint, q_and_v_eval, q_and_v_test
from videonavqa_tpu_torch.cli import q_only_test, results_analysis
from videonavqa_tpu_torch.models import ModelConfig, get_model
from videonavqa_tpu_torch.models import q_only_lstm
from videonavqa_tpu_torch.serve.engine import InferenceEngine
from videonavqa_tpu_torch.train.step import make_optimizer, tree_items
from videonavqa_tpu_torch.utils import checkpoint as tckpt
from videonavqa_tpu_torch.utils.zoo_export import (
    export_model_checkpoint, save_reference_checkpoint)
from videonavqa_tpu_torch.utils.zoo_import import import_model_checkpoint, verify_shapes

from test_reference_layout import _build_reference_layout
from test_torch_harness import _jax_stem, _torch_stem
from test_torch_test_cli import assert_same_tests, run_both
from test_zoo_import import CFG, _make_fake_state_dict, _TorchFilmGP

ZOO = ["bow", "lstm", "v_only_cnn3d", "v_only_cnn2d_lstm", "concat2d",
       "concat3d", "film_gp_pt", "film_attn_pt", "time_multi_hop", "mac"]
FILM = ("film_gp_pt", "film_attn_pt", "time_multi_hop")
TCFG = ModelConfig(**dataclasses.asdict(CFG))
LSTM_ARGS = ["--model", "lstm", "--embed_size", "8", "--hidden_size", "8", "--batch_size", "3",
             "--num_workers", "2", "--compute_dtype", "float32"]
MAC_ARGS = ["--model", "mac", "--mac_dim", "8", "--mac_max_step", "2", "--embed_size", "8",
            "--num_input_channels", "8", "--compute_dtype", "float32", "--batch_size", "3",
            "--num_workers", "2"]
FILM_ARGS = ["--model", "film_attn_pt", "--num_res_blocks", "1", "--num_res_block_channels",
             "16", "--embed_size", "8", "--hidden_size", "8", "--at_hidden_size", "8",
             "--num_input_channels", "8", "--compute_dtype", "float32", "--batch_size", "2",
             "--num_workers", "2"]


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def stand_in_stems(monkeypatch):
    monkeypatch.setattr(jcommon, "load_stem", lambda *a, **k: _jax_stem)
    monkeypatch.setattr(tcommon, "load_stem", lambda *a, **k: _torch_stem)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """4 train, 4 val and 4 test examples of at most 16 frames."""
    out = str(tmp_path_factory.mktemp("interchange_data"))
    generate_synthetic_dataset(out, num_houses=3, trajs_per_house=4, seed=12,
                               video_format="npy", max_frames=16)
    return out


def _carried(jp, js):
    """JAX trees -> the port's (params, state)."""
    flat = flatten_tree(jp, "params/")
    flat.update(flatten_tree(js, "state/"))
    return tckpt.params_from_jax(flat)


def _items(tree):
    return {k: t.detach().numpy() for k, t in tree_items(tree)}


def _assert_same_leaves(got, want, skip=()):
    got, want = _items(got), _items(want)
    assert sorted(got) == sorted(want)
    for k in want:
        if any(part in k for part in skip):
            continue
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@functools.lru_cache(maxsize=None)
def _reference(name):
    """(a reference state_dict, JAX's import of it) of one model, once."""
    sd = _make_fake_state_dict(name, CFG)
    return sd, jax_import(name, sd, CFG)


@pytest.mark.parametrize("name", ZOO)
def test_import_matches_jax(name):
    sd, (jp, js, jmissing) = _reference(name)
    params, state, missing = import_model_checkpoint(name, sd, TCFG)
    assert missing == jmissing == ([f"trunk/conv1x1_{k}" for k in range(CFG.num_res_blocks)]
                                   if name in FILM else [])
    verify_shapes(name, params, state, _init(name, TCFG, 0))
    want_p, want_s = _carried(jp, js)
    _assert_same_leaves(params, want_p, skip=("conv1x1",))
    _assert_same_leaves(state, want_s)
    # the seeded 1x1 convs: the reference init's shapes, drawn from seed 0
    for k in range(CFG.num_res_blocks if name in FILM else 0):
        again = import_model_checkpoint(name, sd, TCFG)[0]["trunk"][f"conv1x1_{k}"]
        got = params["trunk"][f"conv1x1_{k}"]
        assert got["weight"].shape == (16, 16, 1, 1)
        assert torch.equal(got["weight"], again["weight"])


def test_verify_shapes_refuses_another_width():
    sd = _make_fake_state_dict("lstm", CFG)
    params, state, _ = import_model_checkpoint("lstm", sd, TCFG)
    wider = _init("lstm", dataclasses.replace(TCFG, hidden_size=16), 0)
    with pytest.raises(ValueError, match="shape-diff"):
        verify_shapes("lstm", params, state, wider)


@pytest.mark.parametrize("name", ZOO)
def test_export_matches_jax(name):
    """JAX's trees of a reference state_dict (its conv1x1 leaves drawn by
    JAX), exported by both packages."""
    _, (jp, js, _) = _reference(name)
    want = jax_export(name, jp, js, CFG)
    params, state = _carried(jp, js)
    got = export_model_checkpoint(name, params, state, TCFG)
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k]
        assert (g.dtype, g.shape) == (w.dtype, w.shape), k
        assert g.tobytes() == w.tobytes(), k


@pytest.mark.parametrize("name", ZOO)
def test_export_import_roundtrip(name):
    params, state = get_model(name).init(torch.Generator().manual_seed(3), TCFG,
                                         torch.device("cpu"))
    sd = export_model_checkpoint(name, params, state, TCFG)
    params2, state2, missing = import_model_checkpoint(name, sd, TCFG)
    verify_shapes(name, params2, state2, _init(name, TCFG, 0))
    assert missing == ([f"trunk/conv1x1_{k}" for k in range(CFG.num_res_blocks)]
                       if name in FILM else [])
    _assert_same_leaves(params2, params, skip=("conv1x1",))
    _assert_same_leaves(state2, state)


def test_film_gp_golden_parity():
    """A reference-semantics film_gp_pt's state_dict, its conv1x1 layers set
    in the port's trees from the fixture (reference files omit them), gives
    the fixture's logits (the bound of the JAX package's own golden test)."""
    torch.manual_seed(0)
    m = _TorchFilmGP(CFG).eval()
    with torch.no_grad():
        m.bn_init.running_mean.uniform_(-0.2, 0.2)
        m.bn_init.running_var.uniform_(0.9, 1.2)
    sd = {k: v for k, v in m.state_dict().items() if not k.startswith("conv1x1_layers")}
    params, state, missing = import_model_checkpoint("film_gp_pt", sd, TCFG)
    assert missing == ["trunk/conv1x1_0", "trunk/conv1x1_1"]
    verify_shapes("film_gp_pt", params, state, _init("film_gp_pt", TCFG, 0))
    for k in range(CFG.num_res_blocks):
        params["trunk"][f"conv1x1_{k}"] = {
            "weight": m.conv1x1_layers[k].weight.detach().clone(),
            "bias": m.conv1x1_layers[k].bias.detach().clone()}

    rng = np.random.RandomState(0)
    B, T = 3, CFG.max_num_frames
    v_lens = np.array([4, 3, 1])
    q_lens = np.array([5, 9, 2])
    v = rng.randn(B, CFG.num_input_channels, 10, 13, T).astype(np.float32)
    for b in range(B):
        v[b, :, :, :, v_lens[b]:] = 0.0
    q = rng.randint(1, CFG.vocab_size, size=(B, CFG.max_q_len))
    for b in range(B):
        q[b, q_lens[b]:] = 0
    with torch.no_grad():
        want = m(torch.from_numpy(v), torch.from_numpy(q), torch.from_numpy(v_lens),
                 torch.from_numpy(q_lens)).numpy()
    batch = {"v_features": torch.from_numpy(np.ascontiguousarray(v.transpose(0, 4, 2, 3, 1))),
             "question": torch.from_numpy(q), "v_len": torch.from_numpy(v_lens),
             "q_len": torch.from_numpy(q_lens)}
    got, _ = get_model("film_gp_pt").apply(params, state, batch, TCFG)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=2e-4)


def _init(name, cfg, seed):
    return get_model(name).init(torch.Generator().manual_seed(seed), cfg, torch.device("cpu"))


def test_torch_checkpoint_dropin_load(tmp_path, capsys):
    """load_any_checkpoint reads a reference .pt through the importer into
    the templates in place (no Adam moments: the optimizer stays fresh), and
    an npz as load_checkpoint does."""
    params, state = _init("film_attn_pt", TCFG, 0)
    pt = str(tmp_path / "ref.pt")
    save_reference_checkpoint(pt, "film_attn_pt", params, state, TCFG, epoch=4)
    tp, ts = _init("film_attn_pt", TCFG, 1)
    ids = {k: id(t) for k, t in tree_items(tp)}
    opt = make_optimizer(tp, 1e-3)
    meta = tckpt.load_any_checkpoint(pt, model_name="film_attn_pt", cfg=TCFG, params=tp,
                                     state=ts, optimizer=opt)
    assert meta == {"epoch": 4} and not opt.state
    assert {k: id(t) for k, t in tree_items(tp)} == ids
    _assert_same_leaves(tp, params, skip=("conv1x1",))
    _assert_same_leaves(ts, state)
    out = capsys.readouterr().out
    assert "=> Imported reference torch checkpoint" in out
    assert "['trunk/conv1x1_0', 'trunk/conv1x1_1']" in out

    npz = str(tmp_path / "m.npz")
    tckpt.save_checkpoint(npz, params=params, state=state, meta={"epoch": 2})
    tp2, ts2 = _init("film_attn_pt", TCFG, 1)
    meta2 = tckpt.load_any_checkpoint(npz, model_name="film_attn_pt", cfg=TCFG, params=tp2,
                                      state=ts2)
    assert meta2["epoch"] == 2
    _assert_same_leaves(tp2, params)


def test_a_reference_file_of_another_model_is_refused(tmp_path):
    params, state = _init("lstm", TCFG, 0)
    pt = str(tmp_path / "lstm.pt")
    save_reference_checkpoint(pt, "lstm", params, state, TCFG)
    tp, ts = _init("film_attn_pt", TCFG, 0)
    before = {k: t.clone() for k, t in tree_items(tp)}
    with pytest.raises(KeyError, match="film_layer"):
        tckpt.load_any_checkpoint(pt, model_name="film_attn_pt", cfg=TCFG, params=tp, state=ts)
    assert all(torch.equal(t, before[k]) for k, t in tree_items(tp))


def _zero_jax_draws(monkeypatch):
    """The JAX question-only LSTM's (h0, c0) as zeros."""
    shim = types.SimpleNamespace(random=types.SimpleNamespace(
        PRNGKey=jax.random.PRNGKey, split=jax.random.split,
        normal=lambda key, shape: jnp.zeros(shape)))
    monkeypatch.setattr(jax_q_only_lstm, "jax", shim)


def test_q_only_test_lstm_from_a_reference_pt_matches_jax(data_dir, tmp_path, capsys,
                                                           monkeypatch):
    cfg = ModelConfig(model="lstm", embed_size=8, hidden_size=8, compute_dtype="float32")
    params, state = _init("lstm", cfg, 5)
    pt = str(tmp_path / "lstm_ref.pt")
    save_reference_checkpoint(pt, "lstm", params, state, cfg, epoch=0)
    _zero_jax_draws(monkeypatch)
    monkeypatch.setattr(q_only_lstm, "initial_state",
                        lambda generator, shape, device: (torch.zeros(shape),
                                                          torch.zeros(shape)))
    runs = run_both(tmp_path, capsys, monkeypatch, jq_only_test, q_only_test,
                    LSTM_ARGS + ["--data_dir", data_dir], pt)
    assert_same_tests(runs, capsys, 4)


def test_q_and_v_test_mac_from_a_reference_pt_matches_jax(data_dir, tmp_path, capsys,
                                                           monkeypatch, stand_in_stems):
    cfg = ModelConfig(model="mac", mac_dim=8, mac_max_step=2, embed_size=8,
                      num_input_channels=8, compute_dtype="float32")
    params, state = _init("mac", cfg, 6)
    pt = str(tmp_path / "mac_ref.pt")
    save_reference_checkpoint(pt, "mac", params, state, cfg, epoch=1)
    runs = run_both(tmp_path, capsys, monkeypatch, jq_and_v_test, q_and_v_test,
                    MAC_ARGS + ["--data_dir", data_dir], pt)
    assert_same_tests(runs, capsys, 4)


def test_harness_resumes_from_a_reference_pt(data_dir, tmp_path, capsys, stand_in_stems):
    """q_and_v_eval from a reference .pt: the epoch after the file's, Adam
    fresh (its first step at the preset lr), the imported leaves in the
    trained start, and the epoch checkpoint (npz) written beside it."""
    cfg = tcommon.cfg_from_args(tcommon.build_q_and_v_parser().parse_args(FILM_ARGS),
                                "film_attn_pt")
    params, state = _init("film_attn_pt", cfg, 7)
    pt = str(tmp_path / "ref.pt")
    save_reference_checkpoint(pt, "film_attn_pt", params, state, cfg, epoch=3)
    q_and_v_eval.main(FILM_ARGS + ["--device", "cpu", "--data_dir", data_dir, "--num_epochs",
                                   "1", "--checkpoint_path", pt])
    out = capsys.readouterr().out
    assert f"==> Restored checkpoint {pt} (epoch 4)" in out
    assert "re-initialized seeded (reference quirk): ['trunk/conv1x1_0']" in out
    assert "Train Epoch: 4" in out
    tckpt.wait_for_pending_saves()
    e4 = tckpt.epoch_path(pt, 4)
    flat, meta = tckpt.read_npz(e4)
    assert meta["epoch"] == 4
    assert int(flat[tckpt.OPT_INNER_COUNT]) == 2   # 4 train examples at batch 2


def test_engine_serves_and_reloads_a_reference_pt(tmp_path, capsys):
    """The engine (and so the daemon's start, its /reload and predict) from a
    reference .pt: every imported leaf as exported, the conv1x1 leaves drawn
    from seed 0; a reload swaps in another file's weights."""
    cfg = dataclasses.replace(TCFG, model="film_attn_pt", max_num_frames=4)
    params, state = _init("film_attn_pt", cfg, 8)
    first, second = str(tmp_path / "a.pt"), str(tmp_path / "b.pt")
    save_reference_checkpoint(first, "film_attn_pt", params, state, cfg, epoch=2)
    other, other_state = _init("film_attn_pt", cfg, 9)
    save_reference_checkpoint(second, "film_attn_pt", other, other_state, cfg, epoch=5)
    eng = InferenceEngine(cfg, checkpoint_path=first, max_batch=2, frame_buckets=(),
                          device="cpu")
    assert eng.epoch == 2
    _assert_same_leaves(eng.params, params, skip=("conv1x1",))
    seeded = import_model_checkpoint("film_attn_pt", export_model_checkpoint(
        "film_attn_pt", params, state, cfg), cfg)[0]["trunk"]
    for k in range(cfg.num_res_blocks):
        assert torch.equal(eng.params["trunk"][f"conv1x1_{k}"]["weight"],
                           seeded[f"conv1x1_{k}"]["weight"])
    r = np.random.default_rng(0)
    feats = r.standard_normal((4, 10, 13, CFG.num_input_channels)).astype(np.float32)
    items = [(torch.from_numpy(feats), 3, [1, 2, 3])]
    before = eng.run_batch(items)
    assert eng.reload(second) == 5
    _assert_same_leaves(eng.params, other, skip=("conv1x1",))
    assert not np.allclose(eng.run_batch(items), before)
    assert "=> Imported reference torch checkpoint" in capsys.readouterr().out


@pytest.mark.parametrize("model, argv", [
    ("lstm", []),
    ("film_attn_pt", FILM_ARGS[2:12]),
])
def test_export_checkpoint_cli_matches_jax(model, argv, tmp_path):
    """Both CLIs from one npz (JAX's weights): the same state_dict, key for
    key and byte for byte, epoch and model."""
    jargs = jcommon.build_q_and_v_parser().parse_args(argv)
    jcfg = jcommon.cfg_from_args(jargs, model)
    jp, js = jax_get_model(model).init(jax.random.PRNGKey(1), jcfg)
    npz = str(tmp_path / "m.npz")
    jckpt.save_checkpoint(npz, params=jp, state=js, meta={"epoch": 2})
    outs = {}
    for side, main in (("jax", jexport_cli.main), ("port", export_checkpoint.main)):
        outs[side] = str(tmp_path / f"{side}.pt")
        main(["--model", model, "--checkpoint_path", npz, "--out", outs[side]] + argv)
    want, got = (torch.load(outs[s], map_location="cpu", weights_only=False)
                 for s in ("jax", "port"))
    assert (got["epoch"], got["model"]) == (want["epoch"], want["model"]) == (2, model)
    assert list(got["state_dict"]) == list(want["state_dict"])
    for k, w in want["state_dict"].items():
        g = got["state_dict"][k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert g.numpy().tobytes() == w.numpy().tobytes(), k


def test_export_checkpoint_cli_round_trips_the_harness_npz(tmp_path):
    """npz -> .pt -> load_any_checkpoint: bit-equal but for conv1x1."""
    cfg = tcommon.cfg_from_args(tcommon.build_q_and_v_parser().parse_args(FILM_ARGS),
                                "film_attn_pt")
    params, state = _init("film_attn_pt", cfg, 10)
    npz, pt = str(tmp_path / "e0_m.npz"), str(tmp_path / "m.pt")
    tckpt.save_checkpoint(npz, params=params, state=state, meta={"epoch": 0})
    export_checkpoint.main(FILM_ARGS + ["--checkpoint_path", npz, "--out", pt])
    tp, ts = _init("film_attn_pt", cfg, 11)
    assert tckpt.load_any_checkpoint(pt, model_name="film_attn_pt", cfg=cfg, params=tp,
                                     state=ts) == {"epoch": 0}
    _assert_same_leaves(tp, params, skip=("conv1x1",))
    _assert_same_leaves(ts, state)


def test_reference_layout_with_a_reference_pt(tmp_path, capsys, stand_in_stems):
    """The released archive's layout (BGR mp4v videos, 1-based tokens, the
    three JSON files), built by hand, and a reference .pt, unmodified,
    through the port's q_and_v_test and results_analysis."""
    base = str(tmp_path / "data")
    os.makedirs(base)
    _build_reference_layout(base, np.random.RandomState(0))
    argv = ["--model", "film_gp_pt", "--num_res_blocks", "1", "--num_res_block_channels",
            "16", "--num_tail_channels", "4", "--embed_size", "8", "--hidden_size", "8",
            "--num_input_channels", "8", "--compute_dtype", "float32", "--batch_size", "2",
            "--num_workers", "2"]
    cfg = tcommon.cfg_from_args(tcommon.build_q_and_v_parser().parse_args(argv), "film_gp_pt")
    params, state = _init("film_gp_pt", cfg, 12)
    pt = str(tmp_path / "gp_ref.pt")
    save_reference_checkpoint(pt, "film_gp_pt", params, state, cfg, epoch=7)
    summary = q_and_v_test.main(argv + ["--device", "cpu", "--data_dir", base,
                                        "--checkpoint_path", pt])
    assert summary["num_examples"] == 2 and np.isfinite(summary["loss"])
    for prefix in ("t_", "p_", "q_"):
        dump = np.load(str(tmp_path / f"{prefix}gp_ref.pt.npy"))
        assert dump.shape == (2,), prefix
    capsys.readouterr()
    results_analysis.main(["--checkpoint_path", pt])
    assert ">>> Stats for" in capsys.readouterr().out
