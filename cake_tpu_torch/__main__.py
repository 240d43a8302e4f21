import sys

from cake_tpu_torch.cli import main

sys.exit(main())
