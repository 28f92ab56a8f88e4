"""Weight layouts, one file a family of parameter trees, named by a
configuration's ``layout``: ``layout(model)`` lists the leaves."""
