"""The port's config reader and writer against PyYAML, on the CPU.

``lanczosnet_torch.utils.config`` reads the subset of YAML that
``configs/*.yaml`` use without PyYAML. It must give exactly what
``yaml.safe_load`` gives, types and key order included, for every config
of the repo; what it writes PyYAML must read back to the same mapping;
anything outside the subset raises with its line number.
"""

from pathlib import Path

import pytest
import yaml

from lanczosnet_torch.utils.config import (
    AttrDict,
    dumps,
    load_config,
    loads,
    parse_arguments,
    save_config,
)

REPO = Path(__file__).resolve().parents[1]
CONFIGS = sorted((REPO / "configs").glob("*.yaml"))


def test_every_config_is_found():
    assert len(CONFIGS) >= 30


@pytest.mark.parametrize("path", CONFIGS, ids=[p.stem for p in CONFIGS])
def test_reader_equals_yaml_safe_load(path):
    text = path.read_text()
    got, want = loads(text), yaml.safe_load(text)
    assert got == want
    assert repr(got) == repr(want)  # the same types (1 is not 1.0) and key order
    back = dumps(got)
    assert loads(back) == want == yaml.safe_load(back)


def test_save_config_round_trips_through_both_readers(tmp_path):
    cfg = AttrDict.convert({
        "exp_name": "x", "seed": 7, "run_id": "20261016_221738_4242_train",
        "save_dir": "exp/x/20261016_221738_4242_train",
        "comment": "it's a run: #1, with [brackets]",
        "words": ["null", "True", "yes", "on", "~", "1e-3", "0x10", ".inf", "2026-10-16", ""],
        "train": {"lr": 1e-05, "big": 1e16, "half": 0.5, "neg": -3, "flag": False,
                  "none": None, "milestones": [15, 25], "empty": [], "nested": {}},
    })
    path = tmp_path / "config.yaml"
    save_config(cfg, path)
    want = cfg.to_plain()
    assert loads(path.read_text()) == want
    assert yaml.safe_load(path.read_text()) == want
    assert repr(loads(path.read_text())) == repr(want)


@pytest.mark.parametrize(
    "text,line",
    [
        ("a: 1\nb: yes\n", 2),
        ("a: 1\nb:\n  c: ~\n", 3),
        ("a: 1e-3\n", 1),
        ("a:\n  b: 1\n c: 2\n", 3),
        ("a: 1\n  b: 2\n", 2),
        ("a: [1, [2, 3]]\n", 1),
        ("a:\n- x: 1\n", 2),
        ("a: 'open\n", 1),
        ("a: &anchor 1\n", 1),
        ("a: 1\na: 2\n", 2),
        ("a: {b: 1}\n", 1),
        ("---\na: 1\n", 1),
        ("a: 2026-10-16\n", 1),
        ("a: 0x10\n", 1),
        ("a: \"q\"\n", 1),
        ("a: |\n  text\n", 1),
        ("a:\tb\n", 1),
    ],
    ids=["yes", "tilde", "float-without-point", "dedent-into-nothing", "indent",
         "nested-flow", "mapping-in-sequence", "open-quote", "anchor", "duplicate-key",
         "flow-mapping", "document-marker", "date", "hex", "double-quote", "block-scalar",
         "tab"],
)
def test_out_of_subset_raises_with_its_line(text, line):
    with pytest.raises(ValueError, match=f"line {line}:"):
        loads(text)


def test_unwritable_values_raise():
    for bad in ({"a": float("nan")}, {"a": "two\nlines"}, {"a": [{"b": 1}]}, {"a": (1, [2])},
                {1: "int key"}, {"a": object()}):
        with pytest.raises(ValueError):
            dumps(bad)


def test_load_config_mints_the_run_and_writes_its_config(tmp_path):
    src = tmp_path / "qm8_small.yaml"
    src.write_text("dataset:\n  n_max: 16\ntrain:\n  lr: 1.0e-3  # trailing comment\n"
                   f"exp_dir: {tmp_path / 'runs'}\n")
    cfg = load_config(src, is_test=True, comment="a note")
    assert cfg.exp_name == "qm8_small" and cfg.seed == 1234 and cfg.is_test
    assert cfg.run_id.endswith("_test") and cfg.comment == "a note"
    assert Path(cfg.save_dir) == tmp_path / "runs" / "qm8_small" / cfg.run_id
    written = (Path(cfg.save_dir) / "config.yaml").read_text()
    assert loads(written) == yaml.safe_load(written) == cfg.to_plain()
    assert cfg.train.lr == 1e-3 and cfg.dataset.n_max == 16
    cfg2 = load_config(src, make_run_dir=False)
    assert cfg2.run_id.endswith("_train") and not Path(cfg2.save_dir).exists()
    with pytest.raises(AttributeError):
        cfg.missing


def test_parse_arguments_has_the_flags_of_run_exp():
    args = parse_arguments(["-c", "configs/qm8_lanczos_net.yaml"])
    assert (args.config_file, args.log_level, args.comment, args.test) == (
        "configs/qm8_lanczos_net.yaml", "INFO", "", False)
    args = parse_arguments(["--config_file", "x.yaml", "-l", "DEBUG", "-m", "note", "-t"])
    assert (args.config_file, args.log_level, args.comment, args.test) == (
        "x.yaml", "DEBUG", "note", True)
    with pytest.raises(SystemExit):
        parse_arguments([])
