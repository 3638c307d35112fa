"""The port's kernel-contract lint (``repro_torch.analysis.lint``), as
``tests/test_lint.py`` holds the JAX package's: the port's tree is clean
and every waiver in it names its reason, each rule fires on a synthetic
bad source (the tiers "reference" and "cuda", ``torch`` initializers in
half dtypes, a branch on a device value), and the waiver pragma silences
exactly the named rule."""

import subprocess
import sys
from pathlib import Path

from repro_torch.analysis.lint import WAIVER_RE, lint_paths

REPO = Path(__file__).resolve().parent.parent
SRC = REPO / "src" / "repro_torch"


def _lint_src(tmp_path, source, *, subdir="kernels", name="mod.py"):
    d = tmp_path / subdir
    d.mkdir(parents=True, exist_ok=True)
    f = d / name
    f.write_text(source)
    return lint_paths([str(tmp_path)])


def _rules(findings):
    return sorted({f.rule for f in findings})


def test_repo_tree_is_lint_clean():
    findings = lint_paths([str(SRC)])
    assert findings == [], "\n".join(str(f) for f in findings)


def test_cli_exit_status():
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.lint", str(SRC)],
        capture_output=True, text=True,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"})
    assert r.returncode == 0, r.stdout + r.stderr
    assert "lint clean" in r.stdout


def test_impl_dispatch_missing_param(tmp_path):
    fs = _lint_src(tmp_path, "def my_op(x):\n    return x\n", name="ops.py")
    assert _rules(fs) == ["impl-dispatch"]
    assert "no 'impl' parameter" in fs[0].message


def test_impl_dispatch_missing_tier_and_check(tmp_path):
    src = (
        "def my_op(x, impl='reference'):\n"
        "    if impl == 'reference':\n"
        "        return x\n"
        "    return x + 1\n")
    fs = _lint_src(tmp_path, src, name="ops.py")
    msgs = " | ".join(f.message for f in fs)
    assert "_check" in msgs and "cuda" in msgs


def test_impl_dispatch_clean_op(tmp_path):
    src = (
        "def _check(impl):\n    pass\n"
        "def my_op(x, impl='cuda'):\n"
        "    _check(impl)\n"
        "    if impl == 'reference':\n"
        "        return x\n"
        "    return go(x)\n")
    assert _lint_src(tmp_path, src, name="ops.py") == []


def test_kernel_reachability_flags_orphan(tmp_path):
    d = tmp_path / "kernels"
    d.mkdir()
    (d / "ops.py").write_text("from repro_torch.kernels import used\n")
    (d / "used.py").write_text("x = 1\n")
    (d / "orphan.py").write_text("y = 2\n")
    fs = lint_paths([str(tmp_path)])
    assert [(f.rule, Path(f.path).name) for f in fs] \
        == [("kernel-reachability", "orphan.py")]


def test_kernel_reachability_transitive(tmp_path):
    d = tmp_path / "kernels"
    d.mkdir()
    (d / "ops.py").write_text("from repro_torch.kernels import a\n")
    (d / "a.py").write_text("from repro_torch.kernels.b import helper\n")
    (d / "b.py").write_text("def helper():\n    pass\n")
    assert lint_paths([str(tmp_path)]) == []


def test_fp32_accum_flags_half_precision(tmp_path):
    src = (
        "import torch\n"
        "def kern(x):\n"
        "    acc = torch.zeros((8, 8), dtype=torch.bfloat16)\n"
        "    ok = torch.zeros((8, 8), dtype=torch.float32)\n"
        "    return acc + ok\n")
    fs = _lint_src(tmp_path, src)
    assert _rules(fs) == ["fp32-accum"]
    assert len(fs) == 1 and fs[0].line == 3


def test_fp32_accum_flags_every_initializer_and_half(tmp_path):
    src = (
        "import torch\n"
        "a = torch.full((8,), 0.0, dtype=torch.half)\n"
        "b = torch.empty_like(x, dtype=torch.float16)\n"
        "c = torch.zeros(8, dtype=x.dtype)\n"
        "d = torch.ones(8, dtype='bfloat16')\n")
    fs = _lint_src(tmp_path, src)
    assert [f.line for f in fs] == [2, 3, 5]


def test_host_sync_flagged_in_kernels_and_models_not_elsewhere(tmp_path):
    src = (
        "import torch\n"
        "def f(x, flag):\n"
        "    if torch.any(x > 0):\n"
        "        return x\n"
        "    while torch.isnan(x).any():\n"
        "        x = x + 1\n"
        "    if flag and x.shape[0]:\n"
        "        return -x\n"
        "    return x\n")
    fs = _lint_src(tmp_path / "a", src)
    assert _rules(fs) == ["host-sync"] and [f.line for f in fs] == [3, 5]
    assert _rules(_lint_src(tmp_path / "b", src, subdir="models")) == ["host-sync"]
    # the same code outside the model and kernel paths is host-side: allowed
    assert _lint_src(tmp_path / "c", src, subdir="launch") == []


def test_config_field_catches_dead_plumbing(tmp_path):
    decl = (
        "import dataclasses\n"
        "@dataclasses.dataclass\n"
        "class ExperimentConfig:\n"
        "    batch: int = 4\n"
        "    def scaled(self):\n"
        "        return self.batch * 2\n")
    use = (
        "def f(exp):\n"
        "    return exp.batch + exp.nonexistent\n"
        "def g(exp):\n"
        "    return exp.scaled()\n")
    (tmp_path / "experiment.py").write_text(decl)
    (tmp_path / "use.py").write_text(use)
    fs = lint_paths([str(tmp_path)])
    assert [(f.rule, f.line) for f in fs] == [("config-field", 2)]
    assert "nonexistent" in fs[0].message


def test_config_field_checks_ctor_and_replace_keywords(tmp_path):
    decl = (
        "import dataclasses\n"
        "@dataclasses.dataclass\n"
        "class ExperimentConfig:\n"
        "    batch: int = 4\n")
    use = (
        "import dataclasses\n"
        "def f(exp):\n"
        "    a = ExperimentConfig(batch=2)\n"
        "    b = ExperimentConfig(bacth=2)\n"
        "    c = dataclasses.replace(exp, batch=8)\n"
        "    d = dataclasses.replace(exp, batches=8)\n"
        "    return a, b, c, d\n")
    (tmp_path / "experiment.py").write_text(decl)
    (tmp_path / "use.py").write_text(use)
    fs = lint_paths([str(tmp_path)])
    assert [f.line for f in fs] == [4, 6]


def test_waiver_pragma_silences_named_rule_only(tmp_path):
    src = (
        "# lint: allow(impl-dispatch) -- test waiver\n"
        "def my_op(x):\n"
        "    return x\n"
        "def other_op(x):\n"
        "    return x\n")
    fs = _lint_src(tmp_path, src, name="ops.py")
    assert [f.message.split("'")[1] for f in fs] == ["other_op"]
    # a pragma naming a different rule does not silence
    src2 = src.replace("impl-dispatch", "fp32-accum")
    fs2 = _lint_src(tmp_path, src2, name="ops.py")
    assert len(fs2) == 2


def test_every_waiver_in_the_tree_gives_its_reason():
    """Each ``# lint: allow(...)`` pragma in the port names its rules and
    says why after ``--``."""
    waivers = []
    for f in sorted(SRC.rglob("*.py")):
        for n, line in enumerate(f.read_text().splitlines(), 1):
            m = WAIVER_RE.search(line)
            if m:
                waivers.append((f.name, n, line[m.end():]))
    assert len(waivers) >= 4
    for name, n, rest in waivers:
        assert rest.strip().startswith("--") and len(rest.strip()) > 10, (name, n)
