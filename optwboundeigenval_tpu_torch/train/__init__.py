"""Task, trainer and config driver."""
