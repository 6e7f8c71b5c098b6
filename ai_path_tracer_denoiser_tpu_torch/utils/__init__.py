"""Device selection, kernel builds, image IO, native library."""
