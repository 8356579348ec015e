import sys

from ceph_tpu_torch.tools.radoslint.cli import main

sys.exit(main())
