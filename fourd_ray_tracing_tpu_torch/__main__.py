"""``python -m fourd_ray_tracing_tpu_torch``: the batch renderer and the
live session (app.main)."""
import sys

from fourd_ray_tracing_tpu_torch.app import main

sys.exit(main())
