"""Mesh serving on the CPU (the counterpart of tests/test_serve.py's
test_mesh_sharded_serving_matches_single_device).

The engine (serve/engine.py) over a single-process mesh of CPU devices, one
thread a device: dp 4 and dp 2 x mp 2 against the single-device engine on
the same padded micro-batches of ragged lengths, probabilities atol 1e-5,
for film_gp_pt and film_attn_pt (the attention mask's longest video and,
with the int8 trunk, the calibration's absmax over the whole micro-batch),
MAC (its read and write units split over 'model') and the question-only
LSTM (its (h0, c0) drawn over the whole micro-batch). Then the daemon
(cli/serve.py) with --mesh_devices 2 --model_parallel 2 over a feature cache
written by a stand-in stem answers /predict as the single-device engine's
run_batch does, and --mesh_devices 3 with --max_batch 4 exits.
"""

import json
import os
import threading

import numpy as np
import pytest
import torch

from videonavqa_tpu_torch.cli import serve
from videonavqa_tpu_torch.cli.common import cfg_from_args
from videonavqa_tpu_torch.data.synthetic import generate_synthetic_dataset
from videonavqa_tpu_torch.datagen.ontology import ANSWER_VOCAB
from videonavqa_tpu_torch.models import ModelConfig, get_model
from videonavqa_tpu_torch.parallel import make_mesh
from videonavqa_tpu_torch.serve import loadgen
from videonavqa_tpu_torch.serve.engine import InferenceEngine
from videonavqa_tpu_torch.utils import checkpoint as tckpt

from test_torch_feature_cache import write_features

PROB_ATOL = 1e-5
SMALL = dict(num_classes=7, vocab_size=19, embed_size=8, hidden_size=8, at_hidden_size=8,
             num_res_blocks=1, num_res_block_channels=16, num_input_channels=8,
             num_tail_channels=4, mac_dim=16, mac_max_step=3, compute_dtype="float32")
MESHES = [(4, 1), (4, 2)]


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread: the mesh's device threads would otherwise contend
    for the intra-op pool (and starve the tests beside this file)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _items(seed, n, channels=8):
    """``n`` items of 1 to 8 frames (frame bucket 8) and 1 to 5 tokens."""
    r = np.random.default_rng(seed)
    out = []
    for i, vl in enumerate(r.integers(1, 9, n)):
        f = np.zeros((35, 10, 13, channels), np.float32)
        f[:vl] = r.standard_normal((vl, 10, 13, channels))
        out.append((f, int(vl), list(r.integers(1, 19, 1 + i % 5))))
    return out


@pytest.mark.parametrize("model, extra", [("film_gp_pt", {}), ("film_attn_pt", {}),
                                          ("film_attn_pt", {"use_int8_trunk": True}),
                                          ("mac", {}), ("lstm", {})],
                         ids=["film_gp_pt", "film_attn_pt", "film_attn_pt_int8", "mac", "lstm"])
def test_mesh_sharded_serving_matches_single_device(model, extra):
    cfg = ModelConfig(model=model, **SMALL, **extra)
    make = lambda mesh=None: InferenceEngine(cfg, device="cpu", max_batch=8,
                                             frame_buckets=(4, 8), mesh=mesh, seed=3)
    single = make()
    # the first calibrates the int8 trunk; the second serves static int8
    batches = [_items(1, 5), _items(2, 8)][:2 if extra else 1]
    want = [single.run_batch(b) for b in batches]
    for dp, mp in MESHES:
        eng = make(make_mesh(dp * mp, mp, ["cpu"] * (dp * mp)))
        assert eng.mesh.shape == {"data": dp, "model": mp}
        for b, w in zip(batches, want):
            np.testing.assert_allclose(eng.run_batch(b), w, atol=PROB_ATOL)
    if extra:   # every replica holds the one calibration
        scales = [st["trunk"]["int8_scales"] for _, st in eng._weights]
        assert all(s.keys() == scales[0].keys() for s in scales)
        for s in scales:
            for k, v in s.items():
                assert float(v) == float(scales[0][k]) == \
                    float(single.state["trunk"]["int8_scales"][k])


MODEL = ["--model", "film_attn_pt", "--num_res_blocks", "1", "--num_res_block_channels", "16",
         "--embed_size", "8", "--hidden_size", "8", "--at_hidden_size", "8",
         "--num_input_channels", "512", "--vocab_size", "19", "--compute_dtype", "float32"]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(data dir with a test-split feature cache and vocab.json, checkpoint)."""
    base = tmp_path_factory.mktemp("serve_mesh")
    data = str(base / "data")
    generate_synthetic_dataset(data, num_houses=3, trajs_per_house=4, seed=21,
                               video_format="npy", min_frames=16, max_frames=16)
    with open(os.path.join(data, "vocab.json"), "w") as f:
        json.dump({**{f"w{i}": i for i in range(1, 18)}, "?": 18}, f)
    write_features(data, ["test"])
    cfg = cfg_from_args(serve.build_parser().parse_args(MODEL), "film_attn_pt")
    params, state = get_model("film_attn_pt").init(torch.Generator().manual_seed(3), cfg,
                                                   torch.device("cpu"))
    ckpt = str(base / "w.npz")
    tckpt.save_checkpoint(ckpt, params=params, state=state)
    return data, ckpt


def _args(served, *extra):
    data, ckpt = served
    return serve.build_parser().parse_args(
        MODEL + ["--device", "cpu", "--data_dir", data, "--checkpoint_path", ckpt,
                 "--feature_cache", "true", "--max_batch", "4", "--port", "0",
                 "--batch_wait_ms", "20", "--int8_trunk", "true", *extra])


def test_mesh_daemon_answers_as_the_single_device_engine(served):
    engine, batcher, server = serve.build_server(
        _args(served, "--mesh_devices", "2", "--model_parallel", "2"))
    assert engine.mesh.shape == {"data": 1, "model": 2}
    single = InferenceEngine.from_args(_args(served))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        port = server.server_address[1]
        ids = sorted(engine.id_to_idx)
        for i, q in enumerate(["w3 w5 w7", "w17?", "w1 w2 w3 w4", "w4 w4 w2"]):
            single.rng = np.random.RandomState(i)
            engine.rng = np.random.RandomState(i)
            ex = ids[i % len(ids)]
            frames, vl = single.load_example(ex)
            want = single.run_batch([(frames, vl, single.encode_question(q))])[0]
            status, body = loadgen.request(port, "/predict", {"example": ex, "question": q})
            assert status == 200, body
            got = {ANSWER_VOCAB[a]: p for a, p in body["top"]}
            assert ANSWER_VOCAB[body["answer"]] == int(np.argmax(want))
            for c, p in got.items():
                assert abs(p - float(want[c])) <= PROB_ATOL
    finally:
        server.shutdown()
        serve.drain(server, batcher)


def test_max_batch_must_divide_the_data_axis(served):
    with pytest.raises(SystemExit, match="must divide"):
        serve.build_server(_args(served, "--mesh_devices", "3"))
