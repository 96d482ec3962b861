"""The plain references that decide a run's `correct`."""
