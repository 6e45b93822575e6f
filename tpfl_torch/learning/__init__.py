"""Loss, optimizer and data of the port."""
