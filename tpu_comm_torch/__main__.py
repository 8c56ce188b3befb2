import sys

from tpu_comm_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
