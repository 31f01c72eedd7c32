"""One module per kind of traffic; the harness documents their interface."""
