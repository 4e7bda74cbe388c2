"""Host-side audio IO."""
