"""The port's tools against the JAX package's, on the CPU: the WordPiece
trainers and `save_vocab`, `misc` (assert_shape, InfiniteSampler,
check_param_consistency, profiled_function), `utils/dnn.py` (EasyDict, the
Logger tee, format_time, open_url, print_module_summary), `util.py`, the
ResNet-50 trunk under both norms with carried-over weights, the retrieval
embedders and `build_image_database`, and the train_tokenizer and
train_searcher CLIs (the index read back by both packages).
"""
import hashlib
import io
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ealdm_torch import misc as t_misc
from ealdm_torch import util as t_util
from ealdm_torch.data import tokenizer as t_tok
from ealdm_torch.models.resnet import ResNet50 as TorchResNet50
from ealdm_torch.models.resnet import load_torch_resnet50_state
from ealdm_torch.utils import dnn as t_dnn
from ealdm_torch.utils.flax_import import load_flax_params
from ealdm_tpu import misc as j_misc
from ealdm_tpu import util as j_util
from ealdm_tpu.data import tokenizer as j_tok
from ealdm_tpu.models.resnet import ResNet50 as JaxResNet50
from tests.test_torch_port_models import random_tree

torch.set_num_threads(1)
XLA = {"xla_backend_optimization_level": 0}

CORPUS = [
    "The river rose in the storm and the bridge held through the night.",
    "A painting of a river in a storm, oil on canvas, by the old bridge.",
    "Storm clouds gathered over the valley; the rain fell on the river.",
    "Night trains crossed the bridge while the river ran high and fast.",
] * 3


# ------------------------------------------------------------ tokenizer
@pytest.mark.parametrize("trainer,kw", [
    ("train_wordpiece", dict(vocab_size=120)),
    ("train_wordpiece_fast", dict(vocab_size=140, batch_size=7, seed_top_words=6,
                                  seed_min_freq=2, min_pair_freq=2)),
])
def test_wordpiece_trainers_give_jax_vocab(trainer, kw, tmp_path):
    want = getattr(j_tok, trainer)(CORPUS, **kw)
    got = getattr(t_tok, trainer)(CORPUS, **kw)
    assert got == want and len(got) > len(t_tok.SPECIALS) + 20
    t_tok.save_vocab(got, str(tmp_path / "t.txt"))
    j_tok.save_vocab(want, str(tmp_path / "j.txt"))
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()


def test_train_tokenizer_cli_writes_the_vocab_jax_trains(tmp_path, monkeypatch):
    from ealdm_torch.scripts import train_tokenizer as t_cli

    doc = tmp_path / "README.md"
    doc.write_text("\n".join(CORPUS) + "\nimport this line is code\n")
    monkeypatch.setattr(t_cli, "_SOURCES", (str(tmp_path / "*.md"),))
    committed = t_cli.committed_corpus_lines()
    assert len(committed) > 100
    # the committed corpus is held equal to the JAX package's below; a few
    # of its lines keep the two trainings short
    monkeypatch.setattr(t_cli, "committed_corpus_lines", lambda: committed[:20])
    out = tmp_path / "vocab.txt"
    vocab = t_cli.main(["--vocab-size", "300", "--out", str(out)])
    lines = committed[:20] + list(t_cli.harvest_lines())
    assert "import this line is code" not in lines and CORPUS[0] in lines
    assert vocab == j_tok.train_wordpiece_fast(lines, vocab_size=300)
    assert out.read_text().splitlines() == vocab
    default = t_cli.get_parser().parse_args([]).out
    assert os.path.samefile(os.path.dirname(default), os.path.join(
        os.path.dirname(t_cli.__file__), "..", "data"))
    assert "ealdm_tpu" not in default


def test_committed_corpus_is_the_jax_packages():
    from ealdm_torch.scripts import train_tokenizer as t_cli

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, "ealdm_tpu", "data", "corpus_extra.txt"), "rb") as f:
        want = f.read()
    with open(os.path.join(t_cli._DATA, "corpus_extra.txt"), "rb") as f:
        assert f.read() == want


# ----------------------------------------------------------------- misc
@pytest.mark.parametrize("size,rank,replicas,seed,window", [
    (10, 0, 1, 0, 0.5), (37, 1, 3, 5, 0.25), (16, 0, 2, 9, 0.0)])
def test_infinite_sampler_order(size, rank, replicas, seed, window):
    kw = dict(rank=rank, num_replicas=replicas, seed=seed, window_size=window)
    got, want = iter(t_misc.InfiniteSampler(size, **kw)), iter(j_misc.InfiniteSampler(size, **kw))
    assert [next(got) for _ in range(64)] == [next(want) for _ in range(64)]


def test_assert_shape_refuses_as_jax():
    x = torch.zeros(2, 3, 4)
    t_misc.assert_shape(x, [2, None, 4])
    for ref in ([2, 3], [2, 5, 4]):
        with pytest.raises(AssertionError) as got:
            t_misc.assert_shape(x, ref)
        with pytest.raises(AssertionError) as want:
            j_misc.assert_shape(np.zeros((2, 3, 4)), ref)
        assert str(got.value) == str(want.value)


def test_param_consistency_single_process_and_profiled_function():
    m = torch.nn.Linear(3, 2)
    assert float(t_misc.check_param_consistency(m)) == 0.0

    @t_misc.profiled_function
    def twice(x):
        return 2 * x

    with torch.profiler.profile() as prof:
        assert twice(3) == 6
    assert twice.__name__ == "twice"
    assert any(e.key == "twice" for e in prof.key_averages())


_DRIFT_WORKER = """
import sys, torch
from ealdm_torch.misc import check_param_consistency
rank, port = int(sys.argv[1]), sys.argv[2]
torch.distributed.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                     world_size=2, rank=rank)
print(float(check_param_consistency({"w": torch.full((3,), float(rank)),
                                     "b": torch.zeros(2)})))
torch.distributed.destroy_process_group()
"""


def test_param_consistency_over_gloo():
    """Two processes whose `w` are 0 and 1: each is 0.5 from the mean."""
    import socket
    import subprocess

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen([sys.executable, "-c", _DRIFT_WORKER, str(r), str(port)],
                              cwd=repo, stdout=subprocess.PIPE, text=True) for r in (0, 1)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0]
    assert [float(o.split()[-1]) for o in outs] == [0.5, 0.5]


# ------------------------------------------------------------ utils/dnn
def test_easydict_logger_format_time():
    d = t_dnn.EasyDict(a=1)
    d.b = 2
    assert d.a == 1 and d["b"] == 2
    del d.a
    with pytest.raises(AttributeError):
        _ = d.a
    for s in (5, 65, 3725, 90061):
        assert t_dnn.format_time(s) == __import__(
            "ealdm_tpu.utils.dnn", fromlist=["format_time"]).format_time(s)


def test_logger_tees_to_file(tmp_path):
    log = tmp_path / "log.txt"
    stdout = sys.stdout
    with t_dnn.Logger(str(log)):
        print("hello tee")
        print("to stderr", file=sys.stderr)
    assert log.read_text() == "hello tee\nto stderr\n"
    assert sys.stdout is stdout


def test_open_url_local_cached_and_refused(tmp_path):
    f = tmp_path / "x.bin"
    f.write_bytes(b"abc")
    assert t_dnn.open_url(str(f)).read() == b"abc"
    assert t_dnn.open_url(f"file://{f}", return_filename=True) == str(f)
    url = "https://example.com/weights.pkl"
    cache = tmp_path / "cache"
    cache.mkdir()
    (cache / f"{hashlib.md5(url.encode()).hexdigest()}_weights.pkl").write_bytes(b"W")
    assert t_dnn.open_url(url, cache_dir=str(cache)).read() == b"W"
    from ealdm_tpu.utils.dnn import open_url as j_open_url

    missing = "https://example.com/missing"
    with pytest.raises(FileNotFoundError) as got:
        t_dnn.open_url(missing, cache_dir=str(cache))
    with pytest.raises(FileNotFoundError) as want:
        j_open_url(missing, cache_dir=str(cache))
    assert str(got.value) == str(want.value)


def test_module_summary_and_count_params_give_jax_totals():
    import flax.linen as nn

    from ealdm_tpu.utils.dnn import print_module_summary as j_summary

    class J(nn.Module):
        @nn.compact
        def __call__(self, x):
            return nn.Dense(2, name="d2")(nn.Dense(8, name="d1")(x))

    tm = torch.nn.Module()
    tm.d1, tm.d2 = torch.nn.Linear(4, 8), torch.nn.Linear(8, 2)
    want = j_summary(J(), (jnp.zeros((1, 4)),), file=io.StringIO())
    got = t_dnn.print_module_summary(tm, file=io.StringIO())
    assert got.splitlines()[-1] == want.splitlines()[-1]  # TOTAL 58
    assert "d1" in got and "d2" in got
    variables = jax.eval_shape(lambda r: J().init(r, jnp.zeros((1, 4))), jax.random.PRNGKey(0))
    assert t_util.count_params(tm) == j_util.count_params(variables) == 58
    assert t_util.count_params({"a": [np.zeros((2, 3))], "b": np.zeros(4)}) == 10


def test_util_helpers():
    x = torch.arange(24.0).reshape(2, 3, 4)
    np.testing.assert_allclose(t_util.mean_flat(x).numpy(),
                               np.asarray(j_util.mean_flat(jnp.asarray(x.numpy()))))
    for shape in ((1, 4, 4, 3), (1, 4, 4, 8), (4, 4)):
        a = np.zeros(shape)
        assert t_util.ismap(a) == j_util.ismap(a) and t_util.isimage(a) == j_util.isimage(a)
    assert t_util.default(None, lambda: 3) == 3 and t_util.exists(0)
    sq = lambda v: v * v  # noqa: E731
    got = t_util.parallel_data_prefetch(sq, list(range(7)), 3)
    np.testing.assert_array_equal(got, j_util.parallel_data_prefetch(sq, list(range(7)), 3))
    assert t_util.parallel_data_prefetch(sq, np.arange(3), 2, target_data_type="ndarray"
                                         ).tolist() == [0, 1, 4]
    with pytest.raises(NotImplementedError, match="item 10"):
        t_util.log_txt_as_img((64, 64), ["text"])


# ------------------------------------------------------------- ResNet-50
@pytest.fixture(scope="module")
def resnets():
    """norm -> (JAX trunk, its seeded weights, the port's trunk with them)."""
    out = {}
    for norm in ("group", "frozen_bn"):
        jm = JaxResNet50(norm=norm)
        shapes = jax.eval_shape(lambda r: jm.init(r, jnp.zeros((1, 64, 64, 3))),
                                jax.random.PRNGKey(0))
        variables = random_tree(shapes, 3)
        tm = TorchResNet50(norm=norm).eval()
        load_flax_params(tm, variables, device="cpu")
        out[norm] = jm, variables, tm
    return out


@pytest.mark.parametrize("norm", ["group", "frozen_bn"])
def test_resnet50_matches_jax(resnets, norm):
    jm, variables, tm = resnets[norm]
    x = np.random.RandomState(0).randn(2, 64, 64, 3).astype(np.float32)
    fn = jax.jit(lambda v, x: (jm.apply(v, x), jm.apply(v, x, pool=True)))
    want = fn.lower(variables, x).compile(XLA)(variables, x)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)), tm(torch.from_numpy(x), pool=True)
    assert tuple(got[0].shape) == (2, 2, 2, 2048) and tuple(got[1].shape) == (2, 2048)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max())


def test_torchvision_state_dict_loads(resnets):
    """A torchvision-layout state dict (written here) lands where
    `load_torch_resnet50_state`'s renaming says."""
    tm = resnets["frozen_bn"][2]
    sd = {}
    for name, p in tm.named_parameters():
        key = name.replace(".mean", ".running_mean").replace(".var", ".running_var")
        key = key.replace("downsample_conv", "downsample.0").replace("downsample_bn",
                                                                     "downsample.1")
        if key.startswith("layer"):
            head, rest = key.split(".", 1)
            key = head.replace("_", ".") + "." + rest
        sd[key] = torch.randn(p.shape)
    sd["bn1.num_batches_tracked"] = torch.tensor(3)
    fresh = TorchResNet50(norm="frozen_bn")
    load_torch_resnet50_state(fresh, sd)
    assert torch.equal(fresh.layer2_0.downsample_bn.mean, sd["layer2.0.downsample.1.running_mean"])
    assert torch.equal(fresh.layer4_2.conv3.weight, sd["layer4.2.conv3.weight"])
    del sd["conv1.weight"]
    with pytest.raises(ValueError, match="missing"):
        load_torch_resnet50_state(fresh, sd)


# ------------------------------------------------------------- retrieval
def _png_folder(root, n=4, side=32, seed=0):
    from PIL import Image

    root.mkdir()
    rng = np.random.RandomState(seed)
    for i in range(n):
        Image.fromarray((rng.rand(side, side + 8 * i, 3) * 255).astype(np.uint8)).save(
            root / f"im{i}.png")
    return root


def test_build_image_database_equals_jax(tmp_path, resnets, monkeypatch):
    """JAX's `build_image_database` and the port's on 4 PNGs at 32^2, with
    the same "group" trunk weights in both (JAX's `_embed_images_fn`, which
    draws its own from PRNGKey(0), is swapped for one over the fixture's)."""
    import ealdm_tpu.retrieval as j_retrieval
    from ealdm_torch.retrieval import build_image_database as t_build

    jm, variables, _ = resnets["group"]

    def embed_fn():
        def embed(x):
            feats = jm.apply(variables, x, pool=True)
            return feats / (jnp.linalg.norm(feats, axis=-1, keepdims=True) + 1e-8)

        fn = jax.jit(embed).lower(jnp.zeros((4, 32, 32, 3))).compile(XLA)
        return fn

    monkeypatch.setattr(j_retrieval, "_embed_images_fn", embed_fn)
    folder = _png_folder(tmp_path / "imgs")
    want = j_retrieval.build_image_database(str(folder), size=32)
    got = t_build(str(folder), size=32, device="cpu", params=variables)
    assert got["embedding"].shape == (4, 2048)
    np.testing.assert_allclose(got["embedding"], want["embedding"], rtol=0, atol=1e-5)
    for k in ("img_id", "patch_coords", "paths"):
        np.testing.assert_array_equal(got[k], want[k])
    seeded = t_build(str(folder), size=32, device="cpu")["embedding"]
    np.testing.assert_allclose(np.linalg.norm(seeded, axis=1), 1.0, rtol=1e-5)
    (folder / "im9.jpg").write_bytes(b"\xff\xd8")
    with pytest.raises(NotImplementedError, match="item 9"):
        t_build(str(folder), size=32, device="cpu")


def test_text_embedder_equals_jax():
    """`_embed_texts_fn` against its JAX twin's computation (the 4-layer
    TextTransformer, mean-pooled, normalized) on the same weights."""
    from ealdm_torch.retrieval import _embed_texts_fn as t_texts
    from ealdm_tpu.models.text_transformer import SimpleTokenizer, TextTransformer

    texts = ["a stone bridge", "rain over the river at night"]
    jm = TextTransformer(vocab_size=30522, max_len=77, dim=512, depth=4)
    params = random_tree(jax.eval_shape(lambda r: jm.init(r, jnp.zeros((1, 77), jnp.int32)),
                                        jax.random.PRNGKey(0)), 5)

    def embed(tokens):
        pooled = jnp.mean(jm.apply(params, tokens), axis=1)
        return pooled / (jnp.linalg.norm(pooled, axis=-1, keepdims=True) + 1e-8)

    tokens = SimpleTokenizer(max_len=77)(texts)
    want = np.asarray(jax.jit(embed).lower(tokens).compile(XLA)(tokens))
    got = t_texts(device="cpu", params=params)(texts).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_train_searcher_cli(tmp_path):
    """An image folder through ResNet-50, then an .npz with --num_leaves;
    both indexes load in both packages' `Searcher.load`."""
    from ealdm_torch.retrieval import Searcher as TSearcher
    from ealdm_torch.scripts import train_searcher
    from ealdm_tpu.retrieval import Searcher as JSearcher

    folder = tmp_path / "imgs"
    folder.mkdir()
    rng = np.random.RandomState(0)
    for i in range(4):
        np.save(folder / f"im{i}.npy", (rng.rand(32, 32, 3) * 255).astype(np.uint8))
    idx = str(tmp_path / "index.npz")
    train_searcher.main(["-d", str(folder), "-t", idx, "--size", "32", "--device", "cpu"])
    for s in (JSearcher.load(idx), TSearcher.load(idx, device="cpu")):
        assert s.num_entries == 4 and s.dim == 2048
        res = s.search(s.embeddings[:2], k=2)
        assert [int(i) for i in res["nn_indices"][:, 0]] == [0, 1]

    db = str(tmp_path / "db.npz")
    np.savez(db, embedding=rng.randn(64, 16).astype(np.float32))
    idx2 = str(tmp_path / "index_part.npz")
    train_searcher.main(["-d", db, "-t", idx2, "--num_leaves", "8", "--device", "cpu"])
    j2, t2 = JSearcher.load(idx2), TSearcher.load(idx2, device="cpu")
    assert j2.partitioned and t2.partitioned
    assert j2.default_leaves_to_search == t2.default_leaves_to_search == 1  # max(8 // 20, 1)
    q = rng.randn(3, 16).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(j2.search(q, k=4)["nn_indices"]),
                                  t2.search(q, k=4)["nn_indices"].numpy())
