"""Environment variable names the port reads.

Port of the part of ``seldon_core_tpu/utils/env.py`` that the port's tools
need: the load generator's OAuth credentials (``tools/loadtest.py`` takes
them as the defaults of ``--oauth-key`` / ``--oauth-secret``, so a job can
inject them from a secret instead of its command line).
"""

LOADTEST_OAUTH_KEY = "LOADTEST_OAUTH_KEY"
LOADTEST_OAUTH_SECRET = "LOADTEST_OAUTH_SECRET"
