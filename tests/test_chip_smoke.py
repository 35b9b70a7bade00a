"""chip_smoke.py refuses to run anywhere but on a GPU with the repository:
it exits non-zero and prints no result line."""

import os
import shutil
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def test_exits_nonzero_without_gpu(capsys):
    sys.path.insert(0, ROOT)
    import chip_smoke

    assert chip_smoke.main([]) != 0
    assert '"ok"' not in capsys.readouterr().out


def test_exits_nonzero_without_repository(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
