"""``python -m consistent_depth_tpu_torch`` == the main pipeline CLI."""

from .cli.main import main

if __name__ == "__main__":
    main()
