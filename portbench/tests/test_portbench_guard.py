"""The import guard: the harness and the reference load neither JAX nor
the JAX package, the reference loads nothing of the program, and the
command exits nonzero without a card, with no result."""

import json
import os
import subprocess
import sys


HERE = os.path.dirname(os.path.abspath(__file__))
PORTBENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(PORTBENCH)
HARNESS = ["run", "calibrate", "checks", "gen", "hooks", "peaks",
           "tracing"]
REFERENCE = ["reference.chain_dp", "reference.levenshtein",
             "reference.climb", "reference.truth"]


def loaded_after(modules, extra=""):
    code = (
        "import sys, json\n"
        f"sys.path[:0] = [{PORTBENCH!r}, {ROOT!r}]\n"
        f"for m in {modules!r}: __import__(m)\n"
        f"{extra}"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_reference_load_no_jax_and_no_jax_package():
    tops = loaded_after(
        HARNESS + REFERENCE,
        "import run\n"
        "for kind in ('metrics', 'roofline', 'entries'):\n"
        "    import os\n"
        "    for f in sorted(os.listdir(os.path.join(run.HERE, kind))):\n"
        "        run.load(kind, f[:-3])\n"
        "import flye_tpu_torch.main\n")
    assert not tops & {"jax", "jaxlib", "flax", "flye_tpu"}, tops
    assert "flye_tpu_torch" in tops


def test_reference_loads_nothing_of_the_program():
    tops = loaded_after(REFERENCE + ["gen", "peaks"])
    assert not tops & {"jax", "jaxlib", "flax", "flye_tpu",
                       "flye_tpu_torch"}, tops


def test_without_a_card_the_command_exits_nonzero_with_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "pbraw50-asm",
         "--seed", "4000000001", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CPU fallback" in out.stderr


def test_forbidden_names_are_compared_whole(monkeypatch):
    import run
    for name in [m for m in sys.modules
                 if m.split(".")[0] in run.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "flye_tpu_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxfake", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert "jaxlib" in run.forbidden_modules()
