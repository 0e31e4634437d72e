"""Static shape ladders shared by the engine and its tests."""
