"""``python -m repro_torch.analysis.lint`` entry point."""

from repro_torch.analysis.lint.cli import main

if __name__ == "__main__":
    main()
