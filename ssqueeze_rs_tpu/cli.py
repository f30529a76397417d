"""Console entry point (reference parity: `[project.scripts] ssqueeze =
"ssqueeze:main"`, /root/reference/pyproject.toml:21-22, whose `main()`
prints `_rs.hello_from_bin()` — src/ssqueeze/__init__.py:26-27).

Bare `ssqueeze-tpu` reproduces that behavior; subcommands add the
operational surface:

    ssqueeze-tpu               # hello line (reference main() parity)
    ssqueeze-tpu info          # version, backend, devices, native runtime
    ssqueeze-tpu demo [name]   # run a TestSignals demo transform (CPU-safe)
    ssqueeze-tpu bench         # headline benchmark (needs a GPU)
"""
from __future__ import annotations

import argparse
import sys


def _cmd_hello(_args) -> int:
    from .compat import hello_from_bin
    print(hello_from_bin())
    return 0


def _cmd_info(_args) -> int:
    from . import __version__
    from . import native
    print(f"ssqueeze_rs_tpu {__version__}")
    try:
        import jax
        print(f"jax {jax.__version__}, backend={jax.default_backend()}, "
              f"devices={len(jax.devices())}")
    except Exception as e:  # backend init can fail; still useful
        print(f"jax backend unavailable: {e}")
    print(f"native host runtime: "
          f"{'loaded' if native.available() else 'not built (jnp fallback)'}")
    return 0


def _cmd_demo(args) -> int:
    from .signals import TestSignals
    ts = TestSignals(N=args.N)
    ts.demo(args.name)
    return 0


def _cmd_bench(_args) -> int:
    import runpy
    from pathlib import Path
    bench = Path(__file__).resolve().parent.parent / "bench.py"
    if not bench.exists():
        print("bench.py not found (installed package without the repo); "
              "run from a checkout", file=sys.stderr)
        return 2
    runpy.run_path(str(bench), run_name="__main__")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ssqueeze-tpu", description=__doc__)
    sub = p.add_subparsers(dest="cmd")
    sub.add_parser("info", help="version / backend / native runtime")
    d = sub.add_parser("demo", help="run a TestSignals demo")
    d.add_argument("name", nargs="?", default="all")
    d.add_argument("-N", type=int, default=2048)
    sub.add_parser("bench", help="headline benchmark (GPU)")
    args = p.parse_args(argv)
    return {"info": _cmd_info, "demo": _cmd_demo,
            "bench": _cmd_bench, None: _cmd_hello}[args.cmd](args)


if __name__ == "__main__":
    raise SystemExit(main())
