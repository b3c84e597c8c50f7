"""The plain reference: torch and numpy only, no module of the measured package."""
