"""CLI entry: ``python -m sanm_tpu_torch.fea [--device cpu|cuda] <sys.json>
<task.json> [override.json ...]`` (counterpart of the reference ``fea``
binary, ``fea/main.cpp:1104-1119``).  Outputs go to the current
directory."""

import resource
import sys

from .app import do_main


def main():
    ret = do_main(sys.argv[1:])
    usage = resource.getrusage(resource.RUSAGE_SELF)
    print("memory: %.3fGiB" % (usage.ru_maxrss / (1024.0 * 1024)))
    sys.exit(ret)


if __name__ == "__main__":
    main()
