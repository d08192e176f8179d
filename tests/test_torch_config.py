"""The port's YAML reader (``enarf_gan_tpu_torch/config.py``, no PyYAML)
against PyYAML and the JAX package's ``yaml_config``: every config pair of
``configs/`` merges to the same dict, every scalar form of the subset
resolves as ``yaml.safe_load`` resolves it, and what the subset leaves out
(PyYAML's other forms included) raises with its line number."""
import glob
import os

import pytest
import yaml

from enarf_gan_tpu.config import yaml_config as jyaml_config
from enarf_gan_tpu_torch.config import (YAMLSubsetError, load_yaml,
                                        read_yaml, yaml_config)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULTS = sorted(glob.glob(os.path.join(REPO, "configs", "*", "default.yml")))
PAIRS = [(os.path.relpath(c, REPO), os.path.relpath(d, REPO))
         for d in DEFAULTS
         for c in sorted(glob.glob(os.path.join(os.path.dirname(d), "**",
                                                "*.yml"), recursive=True))
         if c != d]


def _plain(x):
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    return x


def test_every_config_is_paired():
    assert len(DEFAULTS) == 4 and len(PAIRS) == 24


@pytest.mark.parametrize("config,default", PAIRS)
def test_config_pair_merges_as_jax(config, default):
    for resume_latest, workers in ((False, 1), (True, 3)):
        got = yaml_config(os.path.join(REPO, config),
                          os.path.join(REPO, default), resume_latest, workers)
        want = jyaml_config(os.path.join(REPO, config),
                            os.path.join(REPO, default), resume_latest,
                            workers)
        assert _plain(got) == _plain(want)
        assert got.dataset.num_workers == workers


@pytest.mark.parametrize("path", sorted(
    os.path.relpath(p, REPO) for p in
    glob.glob(os.path.join(REPO, "configs", "**", "*.yml"), recursive=True)))
def test_config_file_reads_as_pyyaml(path):
    with open(os.path.join(REPO, path)) as f:
        assert read_yaml(os.path.join(REPO, path)) == yaml.safe_load(f)


SCALARS = ["1", "-1", "+1", "0", "1_000", "1.5", "-1.5", "1.", ".5", "-.5",
           "1e-3", "1.0e-3", "1.0E+3", "~", "null", "", "true", "True",
           "false", "FALSE", "tRue", "y", "abc", "a b", "a#b", "a # c",
           "'a # b'", '"a # b"', "it's", "data/x_1176", "http://x",
           '"a"  # c', "1.0.0", "center_fixed", '"narf"']


@pytest.mark.parametrize("text", SCALARS)
def test_scalar_resolves_as_pyyaml(text):
    for doc in (f"k: {text}\n", f"a:\n  k: {text}  \n"):
        got, want = load_yaml(doc), yaml.safe_load(doc)
        got = got.get("a", got)["k"]
        want = want.get("a", want)["k"]
        assert type(got) is type(want) and got == want


@pytest.mark.parametrize("doc,line", [
    ("a: 1\nb: [1, 2]\n", 2), ("a:\n  - 1\n", 2), ("a: {b: 1}\n", 1),
    ("a: &x 1\n", 1), ("a: *x\n", 1), ("a: !!str 1\n", 1), ("a: |\n  x\n", 1),
    ("a: >\n  x\n", 1), ("a: 1\n  b: 2\n", 1), ("a:\n    b: 1\n  c: 2\n", 3),
    ("a:\n\tb: 1\n", 2), ("---\na: 1\n", 1), ("a: 'x\n", 1), ("a: 0x10\n", 1),
    ("a: 010\n", 1), ("a: 1:30\n", 1), ("a: 2020-01-01\n", 1),
    ("a: b: c\n", 1), ("a: 'x' y\n", 1), ("just a scalar\n", 1),
    ('a: "\\q"\n', 1), ('a: "x\\ty"\n', 1), ("a: 'it''s'\n", 1),
    ('"a": 1\n', 1), ("a: yes\n", 1), ("a:\n  b: Off\n", 2),
    ("a: .inf\n", 1), ("a: .nan\n", 1)])
def test_outside_the_subset_raises_with_its_line(doc, line):
    with pytest.raises(YAMLSubsetError) as err:
        load_yaml(doc, "f.yml")
    assert err.value.line == line and f"f.yml, line {line}:" in str(err.value)


def test_empty_document_and_comments():
    assert load_yaml("") is None and load_yaml("# only\n\n") is None
    assert load_yaml("  a: 1 # x\n  b:\n    c: 'd' # e\n#f\n") == \
        {"a": 1, "b": {"c": "d"}}
    assert load_yaml("a: 1\na: 2\n") == {"a": 2}     # the last key wins
