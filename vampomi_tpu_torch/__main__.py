"""`python -m vampomi_tpu_torch ...` runs the CLI (vampomi_tpu_torch/cli.py)."""

from .cli import main

if __name__ == "__main__":
    raise SystemExit(main())
