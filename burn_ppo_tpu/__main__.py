from burn_ppo_tpu.cli import main

raise SystemExit(main())
