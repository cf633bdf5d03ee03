"""Host-side acceleration-structure builders of the torch port."""
