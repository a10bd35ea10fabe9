"""python -m spine_vision_torch.cli"""

from spine_vision_torch.cli import main

main()
