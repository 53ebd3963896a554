'''Puts the checkout's root on sys.path, so that `perfbench` and the program import.'''

import sys
from pathlib import Path

ROOT = str(Path(__file__).resolve().parent.parent.parent)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
