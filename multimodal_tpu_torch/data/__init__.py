"""Host-side text and image preparation for the port."""
