"""`python -m ray_tpu_torch` entry point (the port's `ray_tpu` CLI)."""

from .cli import main

raise SystemExit(main())
