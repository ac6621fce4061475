"""The port's dry run (meteor_demod_tpu_torch/dryrun.py, the counterpart of
__graft_entry__.py): entry() and dryrun_multichip(4) on four "cpu" shards,
in a fresh process with jax and meteor_demod_tpu blocked, which must stay
out of sys.modules. And the rule that only parallel/multihost.py calls
torch.distributed.
"""

import os
import pathlib
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = pathlib.Path(REPO) / "meteor_demod_tpu_torch"


def test_entry_and_dryrun_multichip_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['meteor_demod_tpu'] = None\n"
        "from meteor_demod_tpu_torch.dryrun import dryrun_multichip, entry\n"
        "fn, (carry, block) = entry()\n"
        "assert block.shape == (1, 4096, 2) and block.device.type == 'cpu'\n"
        "carry, out = fn(carry, block)\n"
        "assert int(out.valid.sum()) > 0\n"
        "dryrun_multichip(4)\n"
        "assert sys.modules.get('jax') is None\n"
        "bad = [m for m in sys.modules if m.startswith(('jax.', 'jaxlib',\n"
        "       'meteor_demod_tpu.'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO, METEOR_DEMOD_PLATFORM="cpu")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "dryrun_multichip(4) on cpu, cpu, cpu, cpu" in proc.stdout
    assert proc.stdout.strip().endswith("ok")


def test_only_multihost_calls_torch_distributed():
    callers = sorted(str(p.relative_to(PORT)) for p in PORT.rglob("*.py")
                     if re.search(r"torch\.distributed|\bdist\.",
                                  p.read_text()))
    assert callers == ["parallel/multihost.py"], callers
