"""`python -m wtf_tpu_torch.analysis` -> the port's lint CLI."""

import sys

from wtf_tpu_torch.analysis import main

sys.exit(main())
