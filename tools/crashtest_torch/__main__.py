import sys

from tools.crashtest_torch.harness import main

sys.exit(main())
