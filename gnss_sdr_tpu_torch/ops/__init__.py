"""Loop math and correlators of the tracking engines (torch)."""
