"""The last two public functions of the JAX package with a port counterpart:
models/t5.convert_hf_umt5 (a tiny Hugging Face UMT5EncoderModel state dict
converted by both packages, leaf for leaf, and encoded alike) and
core/config.load_yaml_config (a wan_civitai.yaml-shaped file read by both:
the port parses it without PyYAML, as PyYAML does, and refuses what lies
outside its subset; ParallelConfig's fields are held in
test_torch_isolation.py) (CPU)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from versecrafter_tpu.core import config as jconfig
from versecrafter_tpu.models import t5 as jt5
from versecrafter_tpu_torch.core import config as tconfig
from versecrafter_tpu_torch.models import t5 as tt5

YAML = """\
# the reference's config/wan2.1/wan_civitai.yaml layout
format: civitai
pipeline: Wan
transformer_additional_kwargs:
  transformer_subpath: ./
  dict_mapping:
    in_dim: in_channels
    dim: hidden_size

vae_kwargs:
  vae_subpath: Wan2.1_VAE.pth
  temporal_compression_ratio: 4
  spatial_compression_ratio: 8
text_encoder_kwargs:
  text_encoder_subpath: models_t5_umt5-xxl-enc-bf16.pth
  tokenizer_subpath: google/umt5-xxl
  text_length: 512
  vocab: 256384
  dim: 4096
  dim_attn: 4096
  dim_ffn: 10240
  num_heads: 64
  num_layers: 24
  num_buckets: 32
  shared_pos: False
  dropout: 0.0
scheduler_kwargs:
  scheduler_subpath: null
  num_train_timesteps: 1000
  shift: 5.0
  use_dynamic_shifting: false
  base_shift: 0.5
  max_shift: 0.75
  base_image_seq_len: 256
  max_image_seq_len: 4096
image_encoder_kwargs:
  image_encoder_subpath: "models_clip_open-clip-xlm-roberta-large-vit-huge-14.pth"  # CLIP
boundary: 0.875
transformer_combination_type: 'moe'
empty_section:
levels: [1, 2.5, yes]
"""


def test_load_yaml_config_matches_jax(tmp_path):
    path = tmp_path / "wan_civitai.yaml"
    path.write_text(YAML)
    want = jconfig.load_yaml_config(str(path))
    got = tconfig.load_yaml_config(str(path))
    assert sorted(got) == sorted(want) == ["raw", "scheduler", "t5", "vae"]
    assert got["raw"] == want["raw"]
    for k in ("vae", "t5", "scheduler"):
        assert dataclasses.asdict(got[k]) == dataclasses.asdict(want[k]), k


@pytest.mark.parametrize("text", [
    "a: y\nb: -.5\nc: 0o17\nd: 017\ne: 1e5\nf: 1.0e+5\ng: [a, b,]\nh: 1_000\ni: .5\n"
    "j: 0x_1F\nl: -.inf\nm: 0b101\nn: []\no: -0\np: ~\nq: Off\n",
    "a: 'it''s' # c\nb: \"x\\ty\\u00e9\\\"z\" # d\nc: don't # e\nd: a#b\ne: [1, x y, -2.5]  # f\n",
    "---\nouter:\n  inner:\n    deep: 1\n  empty:\n  after: x\nlast:\n...\n",
    "a:b: 1\nkey: http://x.y/z\n1: one\nyes: t\n",
    "  indented: 1\n  root: 2\n",
    "",
])
def test_parse_yaml_matches_pyyaml(text):
    yaml = pytest.importorskip("yaml")
    assert tconfig.parse_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text,what", [
    ("models:\n  - name: foo\n", "block sequence"),
    ("a: [\"a, b\", c]\n", "flow sequence"),
    ("a: |\n  text\n", "literal block scalar"),
    ("a: >\n  text\n", "folded block scalar"),
    ("a: &x 1\nb: 2\n", "anchor"),
    ("a: 1\nb: *x\n", "alias"),
    ("a: !!str 1\n", "tag"),
    ("a:\n\tb: 1\n", "tab"),
    ("a: {b: 1}\n", "flow mapping"),
    ("a: one\n  two\n", "indented under a key"),
    ("a: 1\n---\nb: 2\n", "more than one document"),
    ("'a': 1\n", "quoted key"),
    ("a: 2024-01-02\n", "timestamp"),
    ("a: 1:30\n", "base-60"),
    ("a: 'open\n  close'\n", "does not close"),
    ("a:\n    b: 1\n  c: 2\n", "matches no mapping"),
    ("a: b: c\n", "mapping inside a value"),
])
def test_parse_yaml_refuses_what_it_does_not_read(text, what):
    """Outside its subset the reader raises, naming the construct, where
    PyYAML would read something else (or raise itself)."""
    with pytest.raises(ValueError, match=what):
        tconfig.parse_yaml(text)


@pytest.fixture(scope="module")
def hf_umt5():
    transformers = pytest.importorskip("transformers")
    hcfg = transformers.UMT5Config(vocab_size=64, d_model=32, d_kv=8, d_ff=48, num_layers=2,
                                   num_heads=4, relative_attention_num_buckets=32,
                                   relative_attention_max_distance=128,
                                   feed_forward_proj="gated-gelu", dropout_rate=0.0)
    torch.manual_seed(0)
    model = transformers.UMT5EncoderModel(hcfg).eval()
    cfg = tconfig.T5Config(vocab=64, dim=32, dim_attn=32, dim_ffn=48, num_heads=4,
                           num_layers=2, num_buckets=32)
    return model.state_dict(), cfg


def test_convert_hf_umt5_matches_jax(hf_umt5):
    sd, cfg = hf_umt5
    jcfg = jconfig.T5Config(**dataclasses.asdict(cfg))
    want = jt5.convert_hf_umt5(sd, jcfg, dtype=jnp.float32)
    got = tt5.convert_hf_umt5(sd, cfg, dtype=torch.float32)

    def leaves(t, prefix=""):
        if isinstance(t, dict):
            for k in sorted(t):
                yield from leaves(t[k], f"{prefix}/{k}")
        elif isinstance(t, list):
            for i, v in enumerate(t):
                yield from leaves(v, f"{prefix}/{i}")
        else:
            yield prefix, t

    w, g = dict(leaves(want)), dict(leaves(got))
    assert sorted(w) == sorted(g)
    for k in w:
        np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]), err_msg=k)
    assert got["blocks"][0]["attn"]["q"].dtype == torch.float32
    bf = tt5.convert_hf_umt5(sd, cfg)
    assert bf["embed"].dtype == torch.bfloat16 and bf["final_norm"].dtype == torch.float32

    ids = np.random.default_rng(0).integers(0, 64, (2, 11))
    mask = np.ones((2, 11), np.int32)
    mask[1, 7:] = 0
    ref = np.asarray(jt5.t5_encode(want, jcfg, jnp.asarray(ids), jnp.asarray(mask)))
    out = tt5.t5_encode(got, cfg, torch.as_tensor(ids), torch.as_tensor(mask)).numpy()
    assert np.abs(out - ref).max() <= 1e-4 * np.abs(ref).max()
