"""A frontend disk cache folder of this test process's own.

Imported by the port's tests that read data through the frontends or run
``cli.train`` (which empties the cache after its run): without it they
would share ``./frontend_cache`` in the working directory with every other
test worker and process started there. A test that sets
``OMR_A2S_CACHE_DIR`` itself (monkeypatch) still does so.
"""

import atexit
import os
import shutil
import tempfile

from omr_a2s_multimodal_transformer_tpu_torch.data.frontends import CACHE_ENV

if CACHE_ENV not in os.environ:
    FOLDER = tempfile.mkdtemp(prefix="frontend_cache_")
    os.environ[CACHE_ENV] = FOLDER
    atexit.register(shutil.rmtree, FOLDER, True)
