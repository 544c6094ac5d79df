"""``python -m dynamo_tpu_torch.frontend``: see ``frontend/main.py``."""

from dynamo_tpu_torch.frontend.main import main

if __name__ == "__main__":
    main()
