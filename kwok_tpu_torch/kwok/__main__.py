import sys

from kwok_tpu_torch.kwok.cli import main

sys.exit(main())
