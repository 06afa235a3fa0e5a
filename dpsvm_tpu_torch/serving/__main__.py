import sys

from dpsvm_tpu_torch.serving import main

if __name__ == "__main__":
    sys.exit(main())
