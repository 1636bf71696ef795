"""The seeded frames and the frozen arithmetic of work and peaks."""
