"""``python -m poreplex_torch``: the command line (commandline.py)."""

from .commandline import __main__

if __name__ == '__main__':
    __main__()
