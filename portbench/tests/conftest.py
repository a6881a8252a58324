"""The benchmark's tests import its modules as its command does, with
portbench/ and the checkout on the path."""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
PORTBENCH = os.path.dirname(HERE)
for p in (PORTBENCH, os.path.dirname(PORTBENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)
