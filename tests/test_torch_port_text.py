"""The port's text stack against the JAX package on the CPU: the WordPiece
and hash-bucket tokenizers (ids exact), and `TextTransformer` at dim 32,
depth 2 over its whole option surface (float32, weights from a seeded
random flax tree through the bridge; flax fails on a missing or misshapen
leaf), plus the dtype flow at bfloat16 (the norms and so the output stay
float32 in both packages)."""
import filecmp
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ealdm_torch.data import tokenizer as t_tok
from ealdm_torch.models import text_transformer as t_tt
from ealdm_torch.utils.flax_import import load_flax_params
from ealdm_tpu.data import tokenizer as j_tok
from ealdm_tpu.models import text_transformer as j_tt
from tests.test_torch_port_cond import flax_shapes_of, gc_paused
from tests.test_torch_port_models import random_tree

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]

PROMPTS = [
    "A painting of a squirrel eating a burger",
    "",
    "Crème brûlée, über-detailed; 4K photo of Zürich's old town at dawn!!",
    "a  photograph\tof an astronaut riding a horse, trending on artstation " * 6,
    "東京 tower at night",
]


def test_vocab_files_are_byte_identical():
    port = REPO / "ealdm_torch" / "data" / "vocab_en.txt"
    assert pathlib.Path(t_tok.default_vocab_path()) == port
    assert filecmp.cmp(port, REPO / "ealdm_tpu" / "data" / "vocab_en.txt", shallow=False)


def test_wordpiece_tokenizer_matches():
    tj, tt = j_tok.WordPieceTokenizer(max_len=32), t_tok.WordPieceTokenizer(max_len=32)
    for p in PROMPTS:
        assert tt.tokenize(p) == tj.tokenize(p)
        assert tt.encode(p) == tj.encode(p)
        assert tt.decode(tt.encode(p)) == tj.decode(tj.encode(p))
    np.testing.assert_array_equal(tt(PROMPTS).numpy(), np.asarray(tj(PROMPTS)))


@pytest.mark.parametrize("vocab_size,branch", [(30522, "wordpiece"), (1024, "hash")])
def test_simple_tokenizer_matches(vocab_size, branch):
    """Both branches: WordPiece when the committed 12,000-entry vocab fits
    vocab_size, the md5 hash buckets when it does not (the tiny txt2img
    config's 1024)."""
    tj, tt = j_tt.SimpleTokenizer(vocab_size, 77), t_tt.SimpleTokenizer(vocab_size, 77)
    assert (tt._wordpiece is not None) == (branch == "wordpiece")
    got, want = tt(PROMPTS), np.asarray(tj(PROMPTS))
    assert got.dtype == torch.int64 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.max()) < vocab_size


def test_simple_tokenizer_refusals(monkeypatch, tmp_path):
    """An explicitly configured vocab never degrades to the hash buckets."""
    for mod in (j_tt, t_tt):
        with pytest.raises(ValueError, match="exceeding"):
            mod.SimpleTokenizer(1024, 16, vocab_path=t_tok.default_vocab_path())
    monkeypatch.setenv(t_tok.VOCAB_ENV_VAR, str(tmp_path / "missing.txt"))
    for mod in (j_tt, t_tt):
        with pytest.raises(FileNotFoundError):
            mod.SimpleTokenizer(30522, 16)


# the Encoder's option surface, one case each (x_transformer.py:370-462)
OPTIONS = {
    "default": {},
    "scalenorm": dict(use_scalenorm=True),
    "rmsnorm": dict(use_rmsnorm=True),
    "rezero": dict(use_rezero=True),
    "gate_residual": dict(gate_residual=True),
    "ff_glu": dict(ff_glu=True),
    "macaron": dict(macaron=True),
    "sandwich": dict(sandwich_coef=1),
    "position_infused": dict(position_infused_attn=True),
    "post_norm": dict(pre_norm=False),
    "residual_attn": dict(residual_attn=True),
}
DIMS = dict(vocab_size=50, max_len=12, dim=32, depth=2, heads=2, dim_head=16)
# every option case in float32, and the default at bfloat16
CASES = {**{(name, "float32"): opts for name, opts in OPTIONS.items()},
         ("default", "bfloat16"): {}}


@pytest.fixture(scope="module")
@gc_paused()
def cases():
    """{case: (port module, tokens, JAX output)}: one seeded random tree a
    case, loaded into the port through the bridge; every case's flax module
    applied in one jitted program."""
    ports = {case: t_tt.TextTransformer(**DIMS, **opts, dtype=getattr(torch, case[1]))
             for case, opts in CASES.items()}
    variables = {case: random_tree(flax_shapes_of(m), i)
                 for i, (case, m) in enumerate(ports.items())}
    for case, m in ports.items():
        load_flax_params(m, variables[case], device="cpu")
    mods = {case: j_tt.TextTransformer(**DIMS, **opts, dtype=getattr(jnp, case[1]))
            for case, opts in CASES.items()}
    tokens = np.random.RandomState(0).randint(0, DIMS["vocab_size"], (3, 10))
    outs = jax.jit(lambda vs: {case: m.apply(vs[case], tokens) for case, m in mods.items()})(
        variables)
    return {case: (ports[case], tokens, np.asarray(outs[case])) for case in CASES}


def _port(cases, name, dtype):
    tm, tokens, want = cases[(name, dtype)]
    with torch.no_grad():
        return want, tm(torch.from_numpy(tokens))


@pytest.mark.parametrize("name", list(OPTIONS))
def test_text_transformer_matches(cases, name):
    """float32: within 2e-5 of the output's scale (the final LayerNorm puts
    it near 1); the sums run in another order on each side."""
    want, got = _port(cases, name, "float32")
    assert got.dtype == torch.float32 and got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5 * scale)


def test_text_transformer_bf16_dtype_flow(cases):
    """At bfloat16 both packages return float32 (flax's LayerNorm has no
    dtype), and agree within 0.1 of the output's scale: two bf16 matmul
    implementations round at different places, depth 2."""
    want, got = _port(cases, "default", "bfloat16")
    assert want.dtype == np.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=0.1 * float(np.abs(want).max()))
