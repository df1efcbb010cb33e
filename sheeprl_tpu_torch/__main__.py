"""``python -m sheeprl_tpu_torch exp=... [key=value ...]``: train."""

from sheeprl_tpu_torch.cli import run

if __name__ == "__main__":
    run()
