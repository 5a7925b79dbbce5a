"""Version resolution of the port, the counterpart of
``mpi4jax_tpu/_version.py`` (a copy: the port imports nothing of the
JAX package).

Resolution order:

1. ``git describe`` when running from a checkout (a ``.git`` next to the
   package): tag-derived with commit distance and hash,
   ``0.1.0+12.gabc1234``; checked first, so a stale installed copy
   cannot shadow the checkout's real version;
2. the installed distribution's metadata (the port ships in the
   ``mpi4jax_tpu`` distribution);
3. the static version of ``pyproject.toml`` (also what a build without
   git gets).
"""

import re
import subprocess
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _fallback():
    try:
        text = (ROOT / "pyproject.toml").read_text()
    except OSError:
        return "0.1.0"
    m = re.search(r'^version\s*=\s*"([^"]+)"', text, re.MULTILINE)
    return m.group(1) if m else "0.1.0"


def _munge_describe(desc):
    """git-describe output -> PEP 440 version string."""
    if desc.startswith("v"):
        desc = desc[1:]
    # pre-release tags (v0.1.0-rc1 / -a2 / -b3) become PEP 440
    # pre-release segments (0.1.0rc1), not local versions
    desc = re.sub(
        r"^(\d[\d.]*)-(rc|a|b|alpha|beta)\.?(\d+)",
        lambda m: m.group(1)
        + {"alpha": "a", "beta": "b"}.get(m.group(2), m.group(2))
        + m.group(3),
        desc,
    )
    return desc.replace("-", "+", 1).replace("-", ".")


def _git(*args):
    out = subprocess.run(["git", *args], cwd=ROOT, capture_output=True,
                         text=True, timeout=5)
    return out.stdout.strip() if out.returncode == 0 else ""


def get_version():
    fallback = _fallback()
    if (ROOT / ".git").exists():
        try:
            # only version-shaped tags
            desc = (_git("describe", "--tags", "--dirty", "--match", "v[0-9]*")
                    or _git("describe", "--tags", "--dirty", "--match",
                            "[0-9]*"))
            if desc:
                return _munge_describe(desc)
            sha = _git("rev-parse", "--short", "HEAD")
            if sha:
                return f"{fallback}+g{sha}"
        except (OSError, subprocess.SubprocessError):
            pass
    try:
        from importlib.metadata import PackageNotFoundError, version

        return version("mpi4jax_tpu")
    except PackageNotFoundError:
        return fallback
