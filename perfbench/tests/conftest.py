import sys
from pathlib import Path

# the checkout's root, where perfbench and the port live
sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
