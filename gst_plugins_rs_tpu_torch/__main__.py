from .launch import main

raise SystemExit(main())
