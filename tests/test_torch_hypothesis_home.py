"""Keep hypothesis's storage out of the repo.

hypothesis writes its example database and its unicode tables under
``storage_directory()``, which defaults to ``.hypothesis/`` in the working
directory, the repo root.  The tracked
``.hypothesis/unicode_data/<version>/codec-utf-8.json.gz`` is rewritten on
every draw of text there (its gzip header holds a temporary file name), so
a test run would change a committed file.  pytest imports every test module
before it runs any test (in each xdist worker too), so pointing the
storage at a directory outside the repo here, at import, takes effect
before any text is drawn.  ``HYPOTHESIS_STORAGE_DIRECTORY``, where set, is
kept.
"""
import os
import tempfile
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

try:
    from hypothesis.configuration import set_hypothesis_home_dir, storage_directory
except ImportError:  # hypothesis is optional (tests/_hypothesis_compat.py)
    storage_directory = None
else:
    set_hypothesis_home_dir(os.environ.get("HYPOTHESIS_STORAGE_DIRECTORY")
                            or Path(tempfile.gettempdir()) / "repro-hypothesis")


def test_hypothesis_storage_lies_outside_the_repo():
    if storage_directory is None:
        pytest.skip("hypothesis is not installed")
    where = storage_directory().resolve()
    assert where != REPO and REPO not in where.parents, where
